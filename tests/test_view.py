"""Interactive viewer tests: camera-rig semantics (driver.cpp:24-51),
key handling (driver.cpp:60-116), ANSI frame encoding, and a scripted
end-to-end run on the cornell fixture."""
import os
import subprocess
import sys

import numpy as np

from rodent_tpu.tools.view import CameraRig, ansi_frame, apply_key
from rodent_tpu.utils.testscenes import CORNELL_OBJ

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _orthonormal(rig):
    for a, b in ((rig.dir, rig.right), (rig.dir, rig.up),
                 (rig.right, rig.up)):
        assert abs(np.dot(a, b)) < 1e-9
    for v in (rig.dir, rig.right, rig.up):
        assert abs(np.linalg.norm(v) - 1.0) < 1e-9


def test_camera_rig_basis_and_move():
    rig = CameraRig((1, 2, 3), (0, 0, -1), (0, 1, 0))
    _orthonormal(rig)
    # right = dir x up (driver.cpp:34): looking down -z with +y up
    # gives right = -x... no: (0,0,-1) x (0,1,0) = (0*0-(-1)*1, ...) =
    # (1, 0, 0)
    np.testing.assert_allclose(rig.right, (1, 0, 0), atol=1e-12)
    # move(x, y, z) = eye += right*x + up*y + dir*z (driver.cpp:49-51)
    rig.move(0.5, 0.25, 2.0)
    np.testing.assert_allclose(rig.eye, (1.5, 2.25, 1.0), atol=1e-12)


def test_camera_rig_rotate_yaw():
    rig = CameraRig((0, 0, 0), (0, 0, -1), (0, 1, 0))
    # positive yaw rotates dir about up by -yaw (driver.cpp:42-43):
    # a right turn — the quarter turn takes -z to +x (toward `right`,
    # matching mouse-right in the reference)
    rig.rotate(np.pi / 2, 0.0)
    np.testing.assert_allclose(rig.dir, (1, 0, 0), atol=1e-9)
    _orthonormal(rig)
    # four quarter turns come back
    for _ in range(3):
        rig.rotate(np.pi / 2, 0.0)
    np.testing.assert_allclose(rig.dir, (0, 0, -1), atol=1e-9)


def test_camera_rig_rotate_pitch():
    rig = CameraRig((0, 0, 0), (0, 0, -1), (0, 1, 0))
    # positive pitch rotates dir about right by -pitch: looking up
    rig.rotate(0.0, -np.pi / 4)
    assert rig.dir[1] > 0.5
    _orthonormal(rig)


def test_apply_key_semantics():
    rig = CameraRig((0, 0, 0), (0, 0, -1), (0, 1, 0))
    moved, quit_, save, sp = apply_key(rig, "U", 0.1)
    assert moved and not quit_ and not save
    np.testing.assert_allclose(rig.eye, (0, 0, -0.1), atol=1e-12)
    # strafe left = -right
    moved, *_ = apply_key(rig, "L", 0.1)
    assert moved and rig.eye[0] < 0
    # speed keys scale tspeed and do NOT move (driver.cpp:113-114)
    moved, quit_, save, sp = apply_key(rig, "+", 0.1)
    assert not moved and abs(sp - 0.11) < 1e-12
    moved, quit_, save, sp = apply_key(rig, "-", sp)
    assert not moved and abs(sp - 0.099) < 1e-9
    # p saves, q and ESC quit
    assert apply_key(rig, "p", 0.1)[2]
    assert apply_key(rig, "q", 0.1)[1]
    assert apply_key(rig, "\x1b", 0.1)[1]


def test_ansi_frame_encoding():
    img = np.zeros((4, 3, 3), np.uint8)
    img[0, :] = (255, 0, 0)   # top row red
    img[1, :] = (0, 255, 0)   # second row green
    s = ansi_frame(img)
    lines = s.split("\n")
    assert len(lines) == 2            # 4 rows -> 2 half-block lines
    assert lines[0].count("▀") == 3
    assert "\x1b[38;2;255;0;0m" in lines[0]   # fg = top pixel
    assert "\x1b[48;2;0;255;0m" in lines[0]   # bg = bottom pixel
    assert lines[0].endswith("\x1b[0m")
    # odd height rounds down
    assert len(ansi_frame(np.zeros((5, 2, 3), np.uint8)).split("\n")) == 2


def test_view_scripted_end_to_end(tmp_path):
    """Scripted session: render, move (restarts accumulation), save via
    'p', quit via 'q'; the PNG lands on disk."""
    out_png = tmp_path / "view.png"
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    r = subprocess.run(
        [sys.executable, "-m", "rodent_tpu.tools.view",
         CORNELL_OBJ, "--eye", "0", "1", "2.7",
         "--dir", "0", "0", "-1", "--width", "32", "--height", "24",
         "--spp", "1", "--max-path-len", "3", "--iters", "4",
         "--keys", "Upq", "--quiet", "--cpu", "-o", str(out_png)],
        capture_output=True, text=True, cwd=ROOT, env=env)
    assert r.returncode == 0, f"view failed:\n{r.stdout}\n{r.stderr}"
    from rodent_tpu.io import png
    img = png.read_png(out_png)
    assert img.shape == (24, 32, 3)
    assert img.mean() > 1  # cornell is lit
