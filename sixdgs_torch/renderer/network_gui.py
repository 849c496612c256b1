"""SIBR remote-viewer TCP server: port of sixdgs_tpu/renderer/network_gui.py.

The same wire protocol as the reference's gaussian_renderer/network_gui.py:
a nonblocking accept on host:port (127.0.0.1:6009 by default),
length-prefixed JSON camera messages in (a 4-byte little-endian length,
then the JSON), raw HWC uint8 RGB bytes and a length-prefixed verify
string out. The received matrices come in the viewer's OpenGL convention;
columns 1-2 of the view (and column 1 of the view-projection) are negated
exactly as the reference does, then both are transposed. Plain sockets and
numpy: nothing here needs torch.
"""

from __future__ import annotations

import json
import socket
import traceback
from dataclasses import dataclass
from typing import Optional

import numpy as np


@dataclass
class GuiCamera:
    """MiniCam analogue (scene/cameras.py:88-109) built from viewer matrices."""

    width: int
    height: int
    FoVy: float
    FoVx: float
    znear: float
    zfar: float
    view: np.ndarray  # [4,4] world->camera (math convention)
    full_proj: np.ndarray  # [4,4]
    camera_center: np.ndarray  # [3]


class NetworkGUI:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self) -> None:
        if self.conn is not None:
            return
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except (BlockingIOError, socket.timeout, OSError):
            pass

    def _read(self):
        length = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(length).decode("utf-8"))

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self):
        """-> (GuiCamera | None, do_training, shs_python, rot_scale_python,
        keep_alive, scaling_modifier)."""
        msg = self._read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, None, None, None, None, None
        try:
            do_training = bool(msg["train"])
            fovy, fovx = msg["fov_y"], msg["fov_x"]
            znear, zfar = msg["z_near"], msg["z_far"]
            shs_python = bool(msg["shs_python"])
            rot_scale_python = bool(msg["rot_scale_python"])
            keep_alive = bool(msg["keep_alive"])
            scaling_modifier = msg["scaling_modifier"]
            # viewer sends glm-style (transposed) matrices; flip the OpenGL
            # axes like the reference, then transpose into math convention
            wvt = np.reshape(np.asarray(msg["view_matrix"], np.float32), (4, 4))
            wvt[:, 1] = -wvt[:, 1]
            wvt[:, 2] = -wvt[:, 2]
            fpt = np.reshape(np.asarray(msg["view_projection_matrix"], np.float32), (4, 4))
            fpt[:, 1] = -fpt[:, 1]
            view = wvt.T
            full_proj = fpt.T
            cam = GuiCamera(
                width=width, height=height, FoVy=fovy, FoVx=fovx,
                znear=znear, zfar=zfar, view=view, full_proj=full_proj,
                camera_center=np.linalg.inv(view)[:3, 3],
            )
        except Exception as e:
            traceback.print_exc()
            raise e
        return cam, do_training, shs_python, rot_scale_python, keep_alive, scaling_modifier

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def disconnect(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.disconnect()
        self.listener.close()


def image_to_bytes(img_chw: np.ndarray) -> bytes:
    """[3, H, W] float -> raw HWC uint8 bytes (train.py:76-83)."""
    arr = np.clip(img_chw, 0.0, 1.0)
    return (
        (np.transpose(arr, (1, 2, 0)) * 255.0).astype(np.uint8).tobytes()
    )
