"""The port's SIBR remote-viewer server (sixdgs_torch.renderer.network_gui)
and ``train_gs --gui`` against the JAX package's, on the CPU, over real
sockets on 127.0.0.1.

* One viewer message through each package's ``NetworkGUI.receive``: every
  returned field and every ``GuiCamera`` field equal (the same numpy code
  on the same JSON), and a camera decoded equal to the one it was made
  from (the column negations and transposes undo the viewer's).
* ``image_to_bytes`` of one float image: the same bytes.
* tests/test_aux_components.py's protocol round trip against the port's
  server, and the no-camera message (width 0) answered by the verify
  string alone.
* ``train_gs --gui --platform cpu`` for 3 iterations with a viewer thread
  sending one message a step (``keep_alive: false`` on the last): one
  frame a step of W*H*3 bytes, each the bytes of the render made at that
  step, which equals ``render_eval`` of the scene at that step through
  the dataset camera the message was made from (to 1e-6), and the
  dataset's absolute path as the verify string.

The viewer thread gives every socket a timeout, and the test joins it
with one, so a server that stops answering fails the test.
"""

import dataclasses
import json
import os
import socket
import threading
import time

import numpy as np
import torch

from sixdgs_tpu.renderer import network_gui as jgui
from sixdgs_tpu.scene.ply_io import store_point_cloud_ply
from sixdgs_torch.apps import train_gs as ttrain_gs
from sixdgs_torch.renderer import network_gui as tgui
from sixdgs_torch.scene.cameras import make_synthetic_camera
from sixdgs_torch.train import gs_trainer as tgs
from tests.test_scene_io import make_blender_dataset
from torch_threads import shared_cores  # noqa: F401 (an autouse fixture)

CLIENT_TIMEOUT = 60.0  # seconds, per socket operation and for the join


def viewer_message(cam, train=True, keep_alive=True, scaling=1.0):
    """The JSON a SIBR viewer sends for a camera: glm-order (transposed)
    matrices with the OpenGL axis flips that ``receive`` undoes."""
    wvt = np.asarray(cam.view, np.float32).T.copy()
    wvt[:, 1:3] *= -1
    fpt = np.asarray(cam.full_proj, np.float32).T.copy()
    fpt[:, 1] *= -1
    return {
        "resolution_x": cam.width, "resolution_y": cam.height, "train": train,
        "fov_y": cam.FoVy, "fov_x": cam.FoVx, "z_near": cam.znear, "z_far": cam.zfar,
        "shs_python": False, "rot_scale_python": False, "keep_alive": keep_alive,
        "scaling_modifier": scaling,
        "view_matrix": wvt.flatten().tolist(),
        "view_projection_matrix": fpt.flatten().tolist(),
    }


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        if not chunk:
            raise ConnectionError(f"server closed after {len(buf)} of {n} bytes")
        buf += chunk
    return buf


def viewer(port, messages, connected, out):
    """Connect to 127.0.0.1:port (retrying until the server listens), set
    ``connected``, send each message and read its answer: out["frames"] is
    a list of (image bytes or None, verify string); an exception goes to
    out["error"]."""
    try:
        deadline = time.monotonic() + CLIENT_TIMEOUT
        while True:
            try:
                sock = socket.create_connection(("127.0.0.1", port), timeout=CLIENT_TIMEOUT)
                break
            except ConnectionRefusedError:
                if time.monotonic() > deadline:
                    raise
                time.sleep(0.005)
        connected.set()
        frames = []
        with sock:
            for msg in messages:
                payload = json.dumps(msg).encode()
                sock.sendall(len(payload).to_bytes(4, "little") + payload)
                n = msg["resolution_x"] * msg["resolution_y"] * 3
                img = _recv_exact(sock, n) if n else None
                length = int.from_bytes(_recv_exact(sock, 4), "little")
                frames.append((img, _recv_exact(sock, length).decode("ascii")))
        out["frames"] = frames
    except Exception as e:  # reported by the test that joins the thread
        out["error"] = e


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def serve_train_gs(monkeypatch, argv, messages):
    """train_gs.main(argv + --gui on a free port) with a viewer thread
    sending ``messages``; the trainer's run waits until the viewer has
    connected, so that its first step serves it. -> (the viewer's frames,
    [(a copy of the scene, the image, the camera, the SH degree, the
    scaling modifier)] per render_gui_camera call)."""
    port = free_port()
    connected, out, renders = threading.Event(), {}, []
    run, render_gui_camera = tgs.GSTrainer.run, tgs.render_gui_camera

    def run_after_connect(self, *a, **k):
        assert connected.wait(CLIENT_TIMEOUT), "the viewer never connected"
        return run(self, *a, **k)

    def recorded(scene, cam, bg, sh_degree, scaling_modifier=1.0, **k):
        img = render_gui_camera(scene, cam, bg, sh_degree, scaling_modifier, **k)
        snapshot = dataclasses.replace(scene, active=scene.active.clone(),
                                       **{n: p.clone() for n, p in scene.params().items()})
        renders.append((snapshot, img, cam, sh_degree, scaling_modifier))
        return img

    monkeypatch.setattr(tgs.GSTrainer, "run", run_after_connect)
    monkeypatch.setattr(tgs, "render_gui_camera", recorded)
    th = threading.Thread(target=viewer, args=(port, messages, connected, out), daemon=True)
    th.start()
    try:
        ttrain_gs.main(argv + ["--gui", "--ip", "127.0.0.1", "--port", str(port)])
    finally:
        th.join(CLIENT_TIMEOUT)
    assert not th.is_alive(), "the viewer thread did not finish"
    if "error" in out:
        raise out["error"]
    return out["frames"], renders


def _ring_camera(width=40, height=30):
    c2w_R = np.array([[1.0, 0, 0], [0, -1.0, 0], [0, 0, -1.0]])  # looking down -z
    pos = np.array([0.2, -0.1, 4.0])
    return make_synthetic_camera(width, height, 0.9, 0.7, c2w_R, -c2w_R.T @ pos)


def _receive_once(gui_mod, msg):
    """One message through ``gui_mod.NetworkGUI.receive`` over a socket."""
    gui = gui_mod.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    connected, out = threading.Event(), {}
    th = threading.Thread(target=viewer, args=(port, [msg], connected, out), daemon=True)
    th.start()
    try:
        assert connected.wait(CLIENT_TIMEOUT)
        for _ in range(500):
            gui.try_connect()
            if gui.conn is not None:
                break
            time.sleep(0.01)
        got = gui.receive()
        gui.send(None if got[0] is None else b"\0" * (got[0].width * got[0].height * 3), "v")
    finally:
        th.join(CLIENT_TIMEOUT)
        gui.close()
    assert not th.is_alive() and "error" not in out, out
    return got


class TestProtocol:
    def test_receive_matches_jax(self):
        cam = _ring_camera()
        msg = viewer_message(cam, train=False, keep_alive=True, scaling=0.75)
        want, got = _receive_once(jgui, msg), _receive_once(tgui, msg)
        assert got[1:] == want[1:] == (False, False, False, True, 0.75)
        for f in ("width", "height", "FoVy", "FoVx", "znear", "zfar"):
            assert getattr(got[0], f) == getattr(want[0], f), f
        for f in ("view", "full_proj", "camera_center"):
            np.testing.assert_array_equal(getattr(got[0], f), getattr(want[0], f))
        np.testing.assert_array_equal(got[0].view, cam.view)
        np.testing.assert_array_equal(got[0].full_proj, cam.full_proj)
        np.testing.assert_allclose(got[0].camera_center, cam.camera_center, atol=1e-6)

    def test_no_camera_message(self):
        msg = dict(viewer_message(_ring_camera()), resolution_x=0)
        assert _receive_once(tgui, msg) == (None,) * 6

    def test_image_to_bytes_matches_jax(self):
        img = np.random.default_rng(3).uniform(-0.2, 1.2, size=(3, 6, 8)).astype(np.float32)
        got = tgui.image_to_bytes(img)
        assert got == jgui.image_to_bytes(img) and len(got) == 3 * 6 * 8

    def test_protocol_roundtrip(self):
        """tests/test_aux_components.py::TestNetworkGUI against the port."""
        gui = tgui.NetworkGUI(port=0)
        port = gui.listener.getsockname()[1]
        msg = {
            "resolution_x": 8, "resolution_y": 6, "train": True,
            "fov_y": 0.8, "fov_x": 0.9, "z_near": 0.01, "z_far": 100.0,
            "shs_python": False, "rot_scale_python": False, "keep_alive": True,
            "scaling_modifier": 1.0,
            "view_matrix": np.eye(4).flatten().tolist(),
            "view_projection_matrix": np.eye(4).flatten().tolist(),
        }
        received = {}

        def client():
            s = socket.create_connection(("127.0.0.1", port), timeout=10)
            payload = json.dumps(msg).encode()
            s.sendall(len(payload).to_bytes(4, "little") + payload)
            want = 8 * 6 * 3 + 4 + len("verify")
            buf = b""
            while len(buf) < want:
                chunk = s.recv(4096)
                if not chunk:
                    break
                buf += chunk
            received["buf"] = buf
            s.close()

        th = threading.Thread(target=client)
        th.start()
        for _ in range(200):
            gui.try_connect()
            if gui.conn is not None:
                break
            time.sleep(0.02)
        assert gui.conn is not None, "client never connected"
        cam, do_training, *_ = gui.receive()
        assert cam.width == 8 and cam.height == 6
        assert do_training is True
        gui.send(tgui.image_to_bytes(np.zeros((3, 6, 8), np.float32)), "verify")
        th.join(timeout=10)
        gui.close()
        buf = received["buf"]
        assert len(buf) == 144 + 4 + 6
        assert int.from_bytes(buf[144:148], "little") == 6
        assert buf[148:] == b"verify"


def gui_dataset(root):
    """A tiny Blender dataset (3 train, 2 test, 24x24) with 200 points."""
    make_blender_dataset(root, n_train=3, n_test=2, size=24)
    rng = np.random.default_rng(0)
    store_point_cloud_ply(os.path.join(root, "points3d.ply"), rng.normal(size=(200, 3)),
                          rng.integers(0, 255, size=(200, 3)))


def gui_argv(root, model, iterations):
    return ["--source_path", root, "--model_path", model, "--eval", "--white_background",
            "--iterations", str(iterations), "--densify_from_iter", "100",
            "--test_iterations", "-1", "--save_iterations", str(iterations), "--quiet",
            "--chunk", "64", "--log_every", "1", "--capacity_bucket", "256",
            "--platform", "cpu"]


class TestTrainGsGui:
    ITERS = 3

    def test_frames_are_the_renders_of_each_step(self, tmp_path, monkeypatch):
        from sixdgs_torch.scene.cameras import camera_list_from_infos
        from sixdgs_torch.scene.dataset_loader import load_data
        from sixdgs_torch.utils.config import dotdict

        root = str(tmp_path / "lego")
        gui_dataset(root)
        info = load_data(dotdict(source_path=root, images=None, eval=True,
                                 white_background=True))
        cam = camera_list_from_infos(info.train_cameras)[1]
        messages = [viewer_message(cam, keep_alive=i < self.ITERS - 1,
                                   scaling=1.0 if i else 0.8) for i in range(self.ITERS)]
        model = str(tmp_path / "out")
        frames, renders = serve_train_gs(monkeypatch, gui_argv(root, model, self.ITERS),
                                         messages)
        assert len(frames) == len(renders) == self.ITERS
        assert os.path.exists(os.path.join(model, "point_cloud", f"iteration_{self.ITERS}",
                                           "point_cloud.ply"))
        bg = torch.ones(3)
        for i, ((img_bytes, verify), (scene, img, gui_cam, sh, scaling)) in enumerate(
                zip(frames, renders)):
            assert verify == os.path.abspath(root)
            assert len(img_bytes) == cam.width * cam.height * 3
            assert img_bytes == tgui.image_to_bytes(img.numpy())
            assert scaling == (1.0 if i else 0.8) and sh == 0
            np.testing.assert_array_equal(gui_cam.view, cam.view)
            if scaling == 1.0:
                want = tgs.render_eval(scene, cam, bg, sh)
                np.testing.assert_allclose(img.numpy(), want.numpy(), atol=1e-6)
        # the scene moved between the frames: the server rendered each step
        assert not torch.equal(renders[1][0].xyz, renders[2][0].xyz)
