"""PLY I/O without external dependencies (gslm_tpu/data/ply.py).

The files are the 3DGS ecosystem's interchange format, byte-identical to
the JAX package's (binary_little_endian 1.0, the same property order):

- point clouds: x,y,z,nx,ny,nz,red,green,blue (dataset_readers.py:123-143)
- gaussian models: x,y,z,nx,ny,nz,f_dc_{0..2},f_rest_{0..3K-4},opacity,
  scale_{0..2},rot_{0..3} with SH coefficients flattened channel-major
  (gaussian_model.py:315-346 save_ply / :353-404 load_ply)
"""

from __future__ import annotations

import os

import numpy as np

_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i1": "char",
              "u2": "ushort", "i2": "short", "u4": "uint", "i4": "int"}
_PLY_TO_NP = {v: k for k, v in _NP_TO_PLY.items()}
_PLY_TO_NP.update({"float32": "f4", "float64": "f8", "uint8": "u1",
                   "int8": "i1", "uint16": "u2", "int16": "i2",
                   "uint32": "u4", "int32": "i4"})


def write_ply(path: str, vertices: np.ndarray, element: str = "vertex"):
    """Write a structured numpy array as binary_little_endian PLY."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    header = ["ply", "format binary_little_endian 1.0",
              f"element {element} {len(vertices)}"]
    for name in vertices.dtype.names:
        dt = vertices.dtype[name]
        header.append(f"property {_NP_TO_PLY[dt.str[1:]]} {name}")
    header.append("end_header\n")
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        f.write(vertices.tobytes())


def read_ply(path: str) -> np.ndarray:
    """Read the (first) vertex element of a PLY file → structured array.
    Supports binary_little_endian and ascii."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        count = 0
        fields = []
        in_vertex = False
        while True:
            line = f.readline().strip().decode("ascii")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("element"):
                _, name, n = line.split()
                in_vertex = name == "vertex"
                if in_vertex:
                    count = int(n)
            elif line.startswith("property") and in_vertex:
                _, typ, name = line.split()
                fields.append((name, _PLY_TO_NP[typ]))
            elif line == "end_header":
                break
        dtype = np.dtype(fields)
        if fmt == "binary_little_endian":
            return np.frombuffer(f.read(count * dtype.itemsize), dtype=dtype,
                                 count=count).copy()
        if fmt == "ascii":
            rows = [tuple(f.readline().split()) for _ in range(count)]
            return np.array(rows, dtype=dtype)
        raise ValueError(f"{path}: unsupported PLY format {fmt}")


# ---------------------------------------------------------------------------
# point clouds (reference storePly/fetchPly, dataset_readers.py:123-143)
# ---------------------------------------------------------------------------

def store_point_cloud(path: str, xyz: np.ndarray, rgb: np.ndarray):
    dtype = [("x", "f4"), ("y", "f4"), ("z", "f4"),
             ("nx", "f4"), ("ny", "f4"), ("nz", "f4"),
             ("red", "u1"), ("green", "u1"), ("blue", "u1")]
    el = np.empty(xyz.shape[0], dtype=dtype)
    for i, n in enumerate(("x", "y", "z")):
        el[n] = xyz[:, i]
        el["n" + n] = 0.0
    for i, n in enumerate(("red", "green", "blue")):
        el[n] = rgb[:, i].astype(np.uint8)
    write_ply(path, el)


def fetch_point_cloud(path: str):
    """→ (points (N,3) f64, colors (N,3) f64 in [0,1], normals (N,3))."""
    v = read_ply(path)
    pts = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float64)
    colors = np.stack([v["red"], v["green"], v["blue"]], axis=1) / 255.0
    if "nx" in (v.dtype.names or ()):
        normals = np.stack([v["nx"], v["ny"], v["nz"]], axis=1).astype(np.float64)
    else:
        normals = np.zeros_like(pts)
    return pts, colors, normals


# ---------------------------------------------------------------------------
# gaussian models (reference save_ply/load_ply, gaussian_model.py:315-404)
# ---------------------------------------------------------------------------

def save_gaussians_ply(path: str, xyz, features_dc, features_rest, opacity,
                       scaling, rotation):
    """Arrays are host numpy with reference shapes: xyz (P,3),
    features_dc (P,1,3), features_rest (P,K,3), opacity (P,1),
    scaling (P,3), rotation (P,4). SH is flattened channel-major
    ((P,K,3) → transpose → (P,3K)), matching gaussian_model.py:322-324."""
    p = xyz.shape[0]
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(p, -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(p, -1)
    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    attrs = np.concatenate([xyz, np.zeros_like(xyz), f_dc, f_rest, opacity,
                            scaling, rotation], axis=1).astype(np.float32)
    el = np.empty(p, dtype=[(n, "f4") for n in names])
    for i, n in enumerate(names):
        el[n] = attrs[:, i]
    write_ply(path, el)


def load_gaussians_ply(path: str, max_sh_degree: int = 3):
    """→ dict of host numpy arrays in GaussianParams layout."""
    v = read_ply(path)
    names = v.dtype.names
    p = len(v)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = np.asarray(v["opacity"], np.float32)[:, None]

    f_dc = np.stack([v[f"f_dc_{i}"] for i in range(3)], axis=1).astype(np.float32)
    rest_names = sorted([n for n in names if n.startswith("f_rest_")],
                        key=lambda s: int(s.split("_")[-1]))
    k = (max_sh_degree + 1) ** 2 - 1
    assert len(rest_names) == 3 * k, (len(rest_names), k)
    f_rest = np.stack([v[n] for n in rest_names], axis=1).astype(np.float32)
    f_rest = f_rest.reshape(p, 3, k).transpose(0, 2, 1)  # → (P, K, 3)

    scale_names = sorted([n for n in names if n.startswith("scale_")],
                         key=lambda s: int(s.split("_")[-1]))
    rot_names = sorted([n for n in names if n.startswith("rot_")],
                       key=lambda s: int(s.split("_")[-1]))
    return dict(
        xyz=xyz,
        features_dc=f_dc.reshape(p, 3, 1).transpose(0, 2, 1),  # (P,1,3)
        features_rest=f_rest,
        opacity=opacity,
        scaling=np.stack([v[n] for n in scale_names], axis=1).astype(np.float32),
        rotation=np.stack([v[n] for n in rot_names], axis=1).astype(np.float32),
    )
