"""gslm_tpu_torch's viewer server (viewer/network_gui.py) against
gslm_tpu's over a loopback socket: the same SIBR message, the same
parameters. The frames agree within 1 LSB on at most 0.1 % of the pixels
(the port's plain compositor and JAX's XLA one round differently; the
uint8 conversion truncates); the verify strings are equal; a client that
goes away is disconnected and the server keeps listening."""

import json
import socket
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from gslm_tpu.models.cameras import camera_from_meta as j_camera_from_meta
from gslm_tpu.ops.rasterize_tiled import RasterConfig as JRasterConfig
from gslm_tpu.renderer import render_jit as j_render
from gslm_tpu.utils.synthetic import make_camera as j_make_camera
from gslm_tpu.utils.synthetic import random_gaussians as j_random_gaussians
from gslm_tpu.viewer import ViewerServer as JViewerServer
from gslm_tpu_torch.models.gaussians import PARAM_GROUPS, params_from_numpy
from gslm_tpu_torch.ops.rasterize_tiled import RasterConfig
from gslm_tpu_torch.viewer import ViewerServer
from torch_threads import one_thread  # noqa: F401 (autouse)

H, W = 48, 64


def _message(meta, train=True, keep_alive=False):
    """The SIBR viewer's pose message: torch-3DGS layout, transposed, with
    columns 1 and 2 negated."""
    wv_t = meta.world_view.T.astype(np.float32).copy()
    wv_t[:, 1] = -wv_t[:, 1]
    wv_t[:, 2] = -wv_t[:, 2]
    fp_t = meta.full_proj.T.astype(np.float32).copy()
    fp_t[:, 1] = -fp_t[:, 1]
    msg = {"resolution_x": W, "resolution_y": H, "train": train,
           "fov_y": meta.fovy, "fov_x": meta.fovx, "z_near": 0.01,
           "z_far": 100.0, "shs_python": False, "rot_scale_python": False,
           "keep_alive": keep_alive, "scaling_modifier": 1.0,
           "view_matrix": wv_t.flatten().tolist(),
           "view_projection_matrix": fp_t.flatten().tolist()}
    payload = json.dumps(msg).encode()
    return len(payload).to_bytes(4, "little") + payload


def _recv(s, n):
    buf = b""
    while len(buf) < n:
        chunk = s.recv(n - len(buf))
        assert chunk, "server closed the connection"
        buf += chunk
    return buf


def _serve_one(server, poll, message):
    """A client connects, sends ``message``, reads the frame and the verify
    string and hangs up; the server polls until it has answered."""
    port = server.listener.getsockname()[1]
    got = {}

    def client():
        with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
            s.sendall(message)
            got["frame"] = _recv(s, H * W * 3)
            n = int.from_bytes(_recv(s, 4), "little")
            got["verify"] = _recv(s, n).decode("ascii")

    t = threading.Thread(target=client)
    t.start()
    for _ in range(400):
        if server.try_connect():
            break
        time.sleep(0.025)
    else:
        raise AssertionError("the viewer client never connected")
    poll()
    t.join(timeout=60)
    return got


@pytest.fixture(scope="module")
def scene():
    jp, jaux = j_random_gaussians(np.random.default_rng(0), n=64,
                                  capacity=64, num_images=1)
    tp = params_from_numpy({g: np.asarray(getattr(jp, g))
                            for g in PARAM_GROUPS}, 3,
                           alive=np.asarray(jaux.alive), device="cpu")
    meta = j_make_camera(height=H, width=W)
    return jp, jaux, tp, meta


def test_frames_and_verify_strings_match_jax(scene, capsys):
    jp, jaux, tp, meta = scene
    jcfg = JRasterConfig(dup_capacity=1 << 12, max_per_tile=128,
                         tile_chunk=4)
    # compile the exact render the poll makes before the client connects
    j_render(jp, j_camera_from_meta(meta), jnp.zeros(3), config=jcfg,
             active_sh_degree=3, alive=jaux.alive).render.block_until_ready()
    frames = {}
    for name, server, poll in (
            ("jax", JViewerServer("127.0.0.1", 0), lambda s: s.poll(
                jp, jaux, jnp.zeros(3), rcfg=jcfg, active_sh_degree=3,
                source_path="/data/scene", training_done=False)),
            ("port", ViewerServer("127.0.0.1", 0), lambda s: s.poll(
                tp, None, torch.zeros(3), rcfg=RasterConfig(
                    dup_capacity=1 << 12), active_sh_degree=3,
                source_path="/data/scene", training_done=False))):
        got = _serve_one(server, lambda: poll(server), _message(meta))
        assert got["verify"] == "/data/scene", name
        frames[name] = np.frombuffer(got["frame"], np.uint8).reshape(H, W, 3)
        server.disconnect()
        server.listener.close()
    d = np.abs(frames["port"].astype(int) - frames["jax"].astype(int))
    assert frames["jax"].sum() > 0
    assert d.max() <= 1 and (d > 0).mean() <= 1e-3, (d.max(),
                                                      (d > 0).mean())


def test_dropped_client_disconnects_cleanly(scene, capsys):
    """After serving a frame the client hangs up: the next poll prints the
    disconnect and drops the connection; the server accepts a new client
    and serves it."""
    _, _, tp, meta = scene
    server = ViewerServer("127.0.0.1", 0)

    def poll():
        server.poll(tp, None, torch.zeros(3), rcfg=RasterConfig(
            dup_capacity=1 << 12), active_sh_degree=3, source_path="s")

    try:
        got = _serve_one(server, poll, _message(meta))
        assert len(got["frame"]) == H * W * 3
        poll()                           # the client has gone
        assert server.conn is None
        assert "viewer disconnected" in capsys.readouterr().err
        got = _serve_one(server, poll, _message(meta))
        assert got["verify"] == "s"
    finally:
        server.close()
