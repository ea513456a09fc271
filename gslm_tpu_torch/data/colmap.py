"""COLMAP sparse-model I/O, binary and text (gslm_tpu/data/colmap.py):
cameras, images (extrinsics) and points3D, with the binary writers the
tests and the on-card smoke run build scenes with. Formats follow the
public COLMAP spec."""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

# model_id → (name, num_params); COLMAP's camera model table
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3), 1: ("PINHOLE", 4), 2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5), 4: ("OPENCV", 8), 5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12), 7: ("FOV", 5), 8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5), 10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: (mid, n) for mid, (name, n) in CAMERA_MODELS.items()}

@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray
    tvec: np.ndarray
    camera_id: int
    name: str
    xys: np.ndarray
    point3d_ids: np.ndarray


def _read(f, n, fmt):
    return struct.unpack("<" + fmt, f.read(n))


def read_cameras_binary(path):
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, 24, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.array(_read(f, 8 * np_, "d" * np_))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def read_cameras_text(path):
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cid = int(parts[0])
            cams[cid] = ColmapCamera(cid, parts[1], int(parts[2]),
                                     int(parts[3]),
                                     np.array(tuple(map(float, parts[4:]))))
    return cams


def read_images_binary(path):
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, 8, "Q")
        for _ in range(n):
            iid = _read(f, 4, "i")[0]
            qvec = np.array(_read(f, 32, "dddd"))
            tvec = np.array(_read(f, 24, "ddd"))
            (cam_id,) = _read(f, 4, "i")
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (npts,) = _read(f, 8, "Q")
            data = _read(f, 24 * npts, "ddq" * npts)
            xys = np.array(data).reshape(npts, 3)[:, :2] if npts else np.zeros((0, 2))
            ids = (np.array(data[2::3], dtype=np.int64) if npts
                   else np.zeros(0, np.int64))
            images[iid] = ColmapImage(iid, qvec, tvec, cam_id,
                                      name.decode("utf-8"), xys, ids)
    return images


def read_images_text(path):
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    for i in range(0, len(lines), 2):
        parts = lines[i].split()
        iid = int(parts[0])
        qvec = np.array(tuple(map(float, parts[1:5])))
        tvec = np.array(tuple(map(float, parts[5:8])))
        cam_id = int(parts[8])
        name = parts[9]
        pts = lines[i + 1].split() if i + 1 < len(lines) else []
        xys = np.array(tuple(map(float, pts))).reshape(-1, 3)[:, :2] \
            if pts else np.zeros((0, 2))
        ids = (np.array(tuple(map(float, pts))).reshape(-1, 3)[:, 2]
               .astype(np.int64) if pts else np.zeros(0, np.int64))
        images[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, ids)
    return images


# one points3D.bin record before its track: id, xyz, rgb, error, track
# length (43 + 8 bytes, packed)
_POINT = np.dtype([("id", "<i8"), ("xyz", "<f8", (3,)), ("rgb", "u1", (3,)),
                   ("error", "<f8"), ("track", "<u8")])


def _points3d_records(path) -> np.ndarray:
    """points3D.bin's records (``_POINT``, the tracks skipped): the file in
    one buffer, one pass over the track lengths for the record offsets,
    then one numpy gather of the fixed fields. The counterpart of the JAX
    package's native parser (``native.parse_points3d_bin``). A file that
    ends inside a record or a track raises ``ValueError``."""
    with open(path, "rb") as f:
        buf = f.read()
    if len(buf) < 8:
        raise ValueError(f"{path}: truncated points3D.bin (no count)")
    (n,) = struct.unpack_from("<Q", buf, 0)
    offsets = np.empty(n, np.int64)
    off, size = 8, _POINT.itemsize
    unpack = struct.Struct("<Q").unpack_from
    for i in range(n):
        if off + size > len(buf):
            raise ValueError(f"{path}: truncated points3D.bin (record {i} "
                             f"of {n})")
        offsets[i] = off
        off += size + 8 * unpack(buf, off + size - 8)[0]
    if off > len(buf):
        raise ValueError(f"{path}: truncated points3D.bin (track {n - 1} "
                         f"of {n})")
    raw = np.frombuffer(buf, np.uint8)
    return raw[offsets[:, None] + np.arange(size)].view(_POINT)[:, 0]


def read_points3d_binary_with_ids(path):
    """→ (ids (N,) i64, xyz (N,3) f64), for tools that index points by
    COLMAP point id."""
    rec = _points3d_records(path)
    return rec["id"].copy(), rec["xyz"].copy()


def read_points3d_text_with_ids(path):
    ids, xyz = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            ids.append(int(parts[0]))
            xyz.append(tuple(map(float, parts[1:4])))
    return np.array(ids, np.int64), np.array(xyz)


def read_points3d_binary(path):
    """→ (xyz (N,3) f64, rgb (N,3) u8, error (N,) f64)."""
    rec = _points3d_records(path)
    return rec["xyz"].copy(), rec["rgb"].copy(), rec["error"].copy()


def read_points3d_text(path):
    xyz, rgb, err = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            xyz.append(tuple(map(float, parts[1:4])))
            rgb.append(tuple(map(int, parts[4:7])))
            err.append(float(parts[7]))
    return (np.array(xyz).reshape(-1, 3), np.array(rgb, np.uint8).reshape(-1, 3),
            np.array(err))


# ---- writers ---------------------------------------------------------------

def write_cameras_binary(cams: dict, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid, np_ = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack("<" + "d" * np_, *np.asarray(cam.params, float)))


def write_images_binary(images: dict, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = len(im.point3d_ids)
            f.write(struct.pack("<Q", npts))
            for xy, pid in zip(im.xys, im.point3d_ids):
                f.write(struct.pack("<ddq", xy[0], xy[1], int(pid)))


def write_points3d_binary(xyz, rgb, err, path):
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<qdddBBBd", i, *xyz[i],
                                *np.asarray(rgb[i], np.uint8), float(err[i])))
            f.write(struct.pack("<Q", 0))
