"""Point-cloud file I/O: .xyz, .ply (ascii and binary), .npy and .npz
(the readers and writers of p2p_bridge_tpu/utils/io.py that the CLIs use;
tests hold them equal, ``write_ply`` byte for byte).

PLY covers vertex elements with float x/y/z (+ optional uchar r/g/b and
float nx/ny/nz) and optional triangle faces (a vertex_indices list).
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "short": "<i2", "ushort": "<u2", "int": "<i4", "int32": "<i4",
    "uint": "<u4", "uint32": "<u4",
}


def read_xyz(path: str) -> np.ndarray:
    """Whitespace-separated floats, one point per row (>= 3 columns)."""
    return np.loadtxt(path, dtype=np.float32)


def write_xyz(path: str, points: np.ndarray) -> None:
    """One point per row, '%.6f' columns."""
    np.savetxt(path, np.asarray(points), fmt="%.6f")


def _read_header(f):
    """-> (format, [(element name, count, [(property, type)])]); a list
    property's type is ("list", count type, value type)."""
    if f.readline().strip() != b"ply":
        raise ValueError(f"{f.name}: not a PLY file")
    fmt = None
    elements = []
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in header")
        tok = line.decode("ascii", "replace").strip().split()
        if not tok:
            continue
        if tok[0] == "format":
            fmt = tok[1]
        elif tok[0] == "element":
            elements.append((tok[1], int(tok[2]), []))
        elif tok[0] == "property":
            if tok[1] == "list":
                elements[-1][2].append((tok[4], ("list", tok[2], tok[3])))
            else:
                elements[-1][2].append((tok[2], tok[1]))
        elif tok[0] == "end_header":
            return fmt, elements


def _read_element(f, fmt, count, props) -> Dict[str, np.ndarray]:
    is_list = any(isinstance(t, tuple) for _, t in props)
    if fmt == "ascii":
        rows = [f.readline().split() for _ in range(count)]
        if not is_list:
            arr = np.array(rows, dtype=np.float64)
            return {p: arr[:, i] for i, (p, _) in enumerate(props)}
        # a single list property (faces)
        return {props[0][0]: np.array([[float(v) for v in r[1:]] for r in rows],
                                      np.float64)}
    little = fmt == "binary_little_endian"
    if not is_list:
        dt = np.dtype([(p, _PLY_DTYPES[t]) for p, t in props])
        if not little:
            dt = dt.newbyteorder(">")
        raw = np.frombuffer(f.read(dt.itemsize * count), dtype=dt)
        return {p: raw[p].astype(np.float64) for p, _ in props}
    cnt_dt = np.dtype(_PLY_DTYPES[props[0][1][1]])
    val_dt = np.dtype(_PLY_DTYPES[props[0][1][2]])
    if not little:
        cnt_dt = cnt_dt.newbyteorder(">")
        val_dt = val_dt.newbyteorder(">")
    rows = []
    for _ in range(count):
        k = int(np.frombuffer(f.read(cnt_dt.itemsize), cnt_dt)[0])
        rows.append(np.frombuffer(f.read(val_dt.itemsize * k), val_dt))
    return {props[0][0]: np.array(rows, np.float64)}


def read_ply(path: str) -> Dict[str, np.ndarray]:
    """-> {"points" [N, 3] f32, optional "colors" [N, 3] f32 in [0, 1],
    "normals" [N, 3] f32, "faces" [F, 3] int64}."""
    out: Dict[str, np.ndarray] = {}
    with open(path, "rb") as f:
        fmt, elements = _read_header(f)
        for name, count, props in elements:
            data = _read_element(f, fmt, count, props)
            if name == "vertex":
                out["points"] = np.stack([data["x"], data["y"], data["z"]],
                                         axis=1).astype(np.float32)
                if "red" in data:
                    out["colors"] = (np.stack([data["red"], data["green"], data["blue"]], 1)
                                     / 255.0).astype(np.float32)
                if "nx" in data:
                    out["normals"] = np.stack([data["nx"], data["ny"], data["nz"]],
                                              1).astype(np.float32)
            elif name == "face":
                out["faces"] = data[next(iter(data))].astype(np.int64)
    return out


def write_ply(
    path: str,
    points: np.ndarray,
    colors: Optional[np.ndarray] = None,
    normals: Optional[np.ndarray] = None,
    faces: Optional[np.ndarray] = None,
    binary: bool = True,
) -> None:
    """Write a PLY file (binary little-endian by default)."""
    points = np.asarray(points, np.float32)
    N = len(points)
    header = ["ply"]
    header.append(
        "format binary_little_endian 1.0" if binary else "format ascii 1.0"
    )
    header += [f"element vertex {N}", "property float x", "property float y",
               "property float z"]
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if normals is not None:
        header += ["property float nx", "property float ny", "property float nz"]
        fields += [("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4")]
    if colors is not None:
        header += ["property uchar red", "property uchar green", "property uchar blue"]
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    if faces is not None:
        header.append(f"element face {len(faces)}")
        header.append("property list uchar int vertex_indices")
    header.append("end_header")

    rec = np.empty(N, dtype=np.dtype(fields))
    rec["x"], rec["y"], rec["z"] = points[:, 0], points[:, 1], points[:, 2]
    if normals is not None:
        normals = np.asarray(normals, np.float32)
        rec["nx"], rec["ny"], rec["nz"] = normals[:, 0], normals[:, 1], normals[:, 2]
    if colors is not None:
        c = np.asarray(colors)
        if c.dtype.kind == "f":
            c = np.clip(c * 255.0, 0, 255)
        c = c.astype(np.uint8)
        rec["red"], rec["green"], rec["blue"] = c[:, 0], c[:, 1], c[:, 2]

    with open(path, "wb") as f:
        f.write(("\n".join(header) + "\n").encode("ascii"))
        if binary:
            f.write(rec.tobytes())
            if faces is not None:
                faces = np.asarray(faces, np.int32)
                frec = np.empty(
                    len(faces), dtype=np.dtype([("n", "u1"), ("v", "<i4", (3,))])
                )
                frec["n"] = 3
                frec["v"] = faces
                f.write(frec.tobytes())
        else:
            for r in rec:
                f.write((" ".join(str(v) for v in r) + "\n").encode("ascii"))
            if faces is not None:
                for face in np.asarray(faces, np.int64):
                    f.write(f"3 {face[0]} {face[1]} {face[2]}\n".encode("ascii"))


def load_point_cloud(path: str) -> Dict[str, np.ndarray]:
    """Dispatch by extension (.xyz / .ply / .npy / .npz)."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".xyz":
        pts = read_xyz(path)
        out = {"points": pts[:, :3]}
        if pts.shape[1] >= 6:
            out["colors"] = pts[:, 3:6]
        return out
    if ext == ".ply":
        return read_ply(path)
    if ext == ".npy":
        return {"points": np.load(path)[:, :3].astype(np.float32)}
    if ext == ".npz":
        d = np.load(path)
        key = "points" if "points" in d else list(d.keys())[0]
        return {"points": np.asarray(d[key], np.float32)[:, :3]}
    raise ValueError(f"unsupported point cloud format: {path}")
