"""PLY codec, byte-compatible with the reference checkpoint format.

The 3DGS PLY attribute schema is the interop contract
(the reference's scene/gaussian_model.py:284-333 for writing, :342-420 for
reading): binary_little_endian vertices with properties
x,y,z,nx,ny,nz,f_dc_0..2,f_rest_0..44,opacity,scale_0..2,rot_0..3 (all f4).
Point-cloud PLYs (x,y,z,nx,ny,nz f4 + red,green,blue u1) match
scene/datasets_utils.py store_ply/fetch_ply.

Implemented directly on numpy structured arrays (no plyfile dependency).
Copy of sixdgs_tpu/scene/ply_io.py; files written by either package are
byte-identical.
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from sixdgs_torch.scene.structures import BasicPointCloud

_PLY_TO_NP = {
    "float": "<f4",
    "float32": "<f4",
    "double": "<f8",
    "float64": "<f8",
    "uchar": "u1",
    "uint8": "u1",
    "char": "i1",
    "int8": "i1",
    "ushort": "<u2",
    "uint16": "<u2",
    "short": "<i2",
    "int16": "<i2",
    "uint": "<u4",
    "uint32": "<u4",
    "int": "<i4",
    "int32": "<i4",
}
_NP_TO_PLY = {"f4": "float", "f8": "double", "u1": "uchar", "i4": "int"}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Read the 'vertex' element of a PLY file into {property: array}."""
    with open(path, "rb") as fh:
        magic = fh.readline().strip()
        if magic != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_vertex = None
        props: List[Tuple[str, str]] = []
        in_vertex = False
        while True:
            line = fh.readline()
            if not line:
                raise ValueError(f"{path}: truncated PLY header")
            tokens = line.decode("ascii", "replace").strip().split()
            if not tokens:
                continue
            if tokens[0] == "format":
                fmt = tokens[1]
            elif tokens[0] == "element":
                in_vertex = tokens[1] == "vertex"
                if in_vertex:
                    n_vertex = int(tokens[2])
            elif tokens[0] == "property" and in_vertex:
                if tokens[1] == "list":
                    raise ValueError("list properties unsupported for vertices")
                props.append((tokens[2], _PLY_TO_NP[tokens[1]]))
            elif tokens[0] == "end_header":
                break
        if n_vertex is None:
            raise ValueError(f"{path}: no vertex element")
        dtype = np.dtype([(name, np_t) for name, np_t in props])
        if fmt == "binary_little_endian":
            data = np.frombuffer(fh.read(dtype.itemsize * n_vertex), dtype=dtype)
        elif fmt == "ascii":
            raw = np.loadtxt(fh, max_rows=n_vertex, ndmin=2)
            data = np.zeros(n_vertex, dtype=dtype)
            for i, (name, _) in enumerate(props):
                data[name] = raw[:, i]
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    return {name: np.ascontiguousarray(data[name]) for name, _ in props}


def write_ply_vertices(path: str, columns: Dict[str, np.ndarray]) -> None:
    """Write a binary_little_endian PLY with a single vertex element."""
    names = list(columns.keys())
    n = len(next(iter(columns.values())))
    dtype = np.dtype(
        [(name, np.asarray(columns[name]).dtype.str.lstrip("<>|=")) for name in names]
    )
    rec = np.zeros(n, dtype=dtype)
    for name in names:
        rec[name] = np.asarray(columns[name])
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as fh:
        fh.write(b"ply\nformat binary_little_endian 1.0\n")
        fh.write(f"element vertex {n}\n".encode())
        for name in names:
            kind = np.dtype(dtype[name]).str.lstrip("<>|=")
            fh.write(f"property {_NP_TO_PLY[kind]} {name}\n".encode())
        fh.write(b"end_header\n")
        rec.tofile(fh)


# ---------------------------------------------------------------- gaussians


def gaussian_attribute_names(sh_degree: int) -> List[str]:
    """Attribute order of the 3DGS checkpoint (gaussian_model.py:284-296)."""
    names = ["x", "y", "z", "nx", "ny", "nz"]
    names += [f"f_dc_{i}" for i in range(3)]
    n_rest = 3 * ((sh_degree + 1) ** 2 - 1)
    names += [f"f_rest_{i}" for i in range(n_rest)]
    names += ["opacity"]
    names += [f"scale_{i}" for i in range(3)]
    names += [f"rot_{i}" for i in range(4)]
    return names


def save_gaussian_ply(
    path: str,
    xyz: np.ndarray,
    features_dc: np.ndarray,
    features_rest: np.ndarray,
    opacity: np.ndarray,
    scaling: np.ndarray,
    rotation: np.ndarray,
) -> None:
    """Save raw (pre-activation) Gaussian parameters.

    Shapes: xyz [N,3]; features_dc [N,1,3]; features_rest [N,R,3] (R = SH rest
    coeffs); opacity [N,1]; scaling [N,3] (log); rotation [N,4].
    Channel flattening matches the reference save: features are stored
    transposed to [N, 3, R] then flattened (gaussian_model.py:303-318).
    """
    n = xyz.shape[0]
    f_dc = np.transpose(features_dc, (0, 2, 1)).reshape(n, -1)
    f_rest = np.transpose(features_rest, (0, 2, 1)).reshape(n, -1)
    cols: Dict[str, np.ndarray] = {}
    for i, name in enumerate(["x", "y", "z"]):
        cols[name] = xyz[:, i].astype("<f4")
    for name in ["nx", "ny", "nz"]:
        cols[name] = np.zeros(n, "<f4")
    for i in range(f_dc.shape[1]):
        cols[f"f_dc_{i}"] = f_dc[:, i].astype("<f4")
    for i in range(f_rest.shape[1]):
        cols[f"f_rest_{i}"] = f_rest[:, i].astype("<f4")
    cols["opacity"] = opacity.reshape(n).astype("<f4")
    for i in range(3):
        cols[f"scale_{i}"] = scaling[:, i].astype("<f4")
    for i in range(4):
        cols[f"rot_{i}"] = rotation[:, i].astype("<f4")
    write_ply_vertices(path, cols)


def load_gaussian_ply(path: str, sh_degree: int):
    """Load raw Gaussian parameters from a 3DGS checkpoint PLY.

    Returns dict of numpy arrays with the shapes of save_gaussian_ply.
    Matches the reference reader (gaussian_model.py:342-420), including the
    sorted-by-index attribute collection.
    """
    cols = read_ply_vertices(path)
    xyz = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float32)
    n = xyz.shape[0]
    opacity = cols["opacity"].reshape(n, 1).astype(np.float32)
    f_dc = np.zeros((n, 3, 1), np.float32)
    for i in range(3):
        f_dc[:, i, 0] = cols[f"f_dc_{i}"]
    rest_names = sorted(
        (k for k in cols if k.startswith("f_rest_")), key=lambda s: int(s.split("_")[-1])
    )
    expected = 3 * ((sh_degree + 1) ** 2 - 1)
    if len(rest_names) != expected:
        raise ValueError(
            f"{path}: expected {expected} f_rest attrs for sh_degree={sh_degree}, "
            f"found {len(rest_names)}"
        )
    f_rest = np.stack([cols[k] for k in rest_names], axis=1).astype(np.float32)
    f_rest = f_rest.reshape(n, 3, (sh_degree + 1) ** 2 - 1)
    scale_names = sorted(
        (k for k in cols if k.startswith("scale_")), key=lambda s: int(s.split("_")[-1])
    )
    scaling = np.stack([cols[k] for k in scale_names], axis=1).astype(np.float32)
    rot_names = sorted(
        (k for k in cols if k.startswith("rot")), key=lambda s: int(s.split("_")[-1])
    )
    rotation = np.stack([cols[k] for k in rot_names], axis=1).astype(np.float32)
    return {
        "xyz": xyz,
        # [N, R, 3] layout (transpose of on-disk [N, 3, R], gaussian_model.py:396-407)
        "features_dc": np.transpose(f_dc, (0, 2, 1)),
        "features_rest": np.transpose(f_rest, (0, 2, 1)),
        "opacity": opacity,
        "scaling": scaling,
        "rotation": rotation,
    }


# ------------------------------------------------------------- point clouds


def store_point_cloud_ply(path: str, xyz: np.ndarray, rgb: np.ndarray) -> None:
    """Point-cloud PLY with u1 colors (datasets_utils.py store_ply)."""
    n = xyz.shape[0]
    cols = {
        "x": xyz[:, 0].astype("<f4"),
        "y": xyz[:, 1].astype("<f4"),
        "z": xyz[:, 2].astype("<f4"),
        "nx": np.zeros(n, "<f4"),
        "ny": np.zeros(n, "<f4"),
        "nz": np.zeros(n, "<f4"),
        "red": rgb[:, 0].astype("u1"),
        "green": rgb[:, 1].astype("u1"),
        "blue": rgb[:, 2].astype("u1"),
    }
    write_ply_vertices(path, cols)


def fetch_point_cloud_ply(path: str) -> BasicPointCloud:
    """Read a point-cloud PLY (datasets_utils.py fetch_ply)."""
    cols = read_ply_vertices(path)
    positions = np.stack([cols["x"], cols["y"], cols["z"]], axis=1).astype(np.float64)
    colors = (
        np.stack([cols["red"], cols["green"], cols["blue"]], axis=1).astype(np.float64)
        / 255.0
    )
    if "nx" in cols:
        normals = np.stack([cols["nx"], cols["ny"], cols["nz"]], axis=1).astype(
            np.float64
        )
    else:
        normals = np.zeros_like(positions)
    return BasicPointCloud(points=positions, colors=colors, normals=normals)
