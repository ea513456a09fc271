"""TCP server speaking the SIBR remote-viewer protocol
(gslm_tpu/viewer/network_gui.py), so the stock SIBR remote viewer can watch
training live:

  wire in : [4-byte LE length][JSON] with camera pose/fov/flags; matrices
            arrive in the torch-3DGS transposed layout with columns 1,2
            negated — undone here to build the row-convention Camera.
  wire out: raw H*W*3 RGB bytes of the rendered frame, then
            [4-byte LE length][ascii training-state string].

The listener never blocks training: ``try_connect`` polls a non-blocking
accept every iteration. Each requested pose is rendered by
``renderer.render`` (kernel A on the card) under ``torch.no_grad()``.
"""

from __future__ import annotations

import json
import math
import socket
import traceback

import numpy as np
import torch


class ViewerServer:
    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host, self.port = host, port
        self.conn = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        self.listener.listen()
        self.listener.settimeout(0)

    # --- low-level wire ops (reference network_gui.py:34-55) -----------
    def try_connect(self):
        try:
            self.conn, addr = self.listener.accept()
            print(f"\nConnected by {addr}")
            self.conn.settimeout(None)
        except Exception:
            pass
        return self.conn is not None

    def _recv_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def read(self) -> dict:
        n = int.from_bytes(self._recv_exact(4), "little")
        return json.loads(self._recv_exact(n).decode("utf-8"))

    def send(self, image_bytes: bytes | None, verify: str):
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(bytes(verify, "ascii"))

    def receive(self, device):
        """Parse one viewer message into (Camera on ``device`` or None,
        flags dict)."""
        from gslm_tpu_torch.models.cameras import Camera

        msg = self.read()
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, {}
        flags = {
            "do_training": bool(msg["train"]),
            "keep_alive": bool(msg["keep_alive"]),
            "scaling_modifier": float(msg["scaling_modifier"]),
        }
        # undo the torch layout: transpose + re-negate columns 1, 2
        wv_t = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv_t[:, 1] = -wv_t[:, 1]
        wv_t[:, 2] = -wv_t[:, 2]
        fp_t = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp_t[:, 1] = -fp_t[:, 1]
        world_view = wv_t.T
        campos = np.linalg.inv(world_view)[:3, 3]

        def t(x, dtype=torch.float32):
            return torch.tensor(x, dtype=dtype, device=device)

        cam = Camera(world_view=t(world_view), full_proj=t(fp_t.T),
                     campos=t(campos),
                     tanfovx=t(math.tan(msg["fov_x"] * 0.5)),
                     tanfovy=t(math.tan(msg["fov_y"] * 0.5)),
                     exposure_idx=t(0, torch.int64), height=height,
                     width=width)
        return cam, flags

    def disconnect(self):
        if self.conn is not None:
            try:
                self.conn.close()
            except Exception:
                pass
        self.conn = None

    def close(self):
        """Drop the client and stop listening."""
        self.disconnect()
        self.listener.close()

    # --- training-loop integration (reference train.py:74-87) ----------
    def poll(self, params, aux, bg, *, rcfg, active_sh_degree, source_path,
             training_done: bool = False):
        """Serve viewer frames until the viewer releases training: render
        each requested pose; go back to training when the viewer asks for
        training and training isn't finished (or it dropped keep_alive).
        A client that goes away is disconnected with its traceback
        printed. ``aux`` is unused: the mask is ``params.alive``."""
        from gslm_tpu_torch.renderer import render

        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                cam, flags = self.receive(bg.device)
                img_bytes = None
                if cam is not None:
                    with torch.no_grad():
                        out = render(params, cam, bg, config=rcfg,
                                     active_sh_degree=active_sh_degree,
                                     scaling_modifier=flags[
                                         "scaling_modifier"],
                                     alive=params.alive)
                        scaled = torch.clamp(out.render, 0, 1) * 255
                    arr = scaled.cpu().numpy().astype(np.uint8).transpose(
                        1, 2, 0)
                    img_bytes = memoryview(np.ascontiguousarray(arr))
                self.send(img_bytes, source_path)
                if flags.get("do_training", True) and (
                        not training_done or not flags.get("keep_alive",
                                                           False)):
                    break
            except Exception:
                traceback.print_exc()
                self.disconnect()
