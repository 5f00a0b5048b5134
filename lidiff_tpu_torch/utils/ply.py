"""Minimal PLY point-cloud I/O (counterpart of lidiff_tpu/utils/ply.py, a
copy: the port imports nothing of the JAX package).

Reads ascii, binary_little_endian and binary_big_endian files with scalar
vertex properties; writes binary_little_endian with optional normals.
`estimate_normals` gives PCA normals from k nearest neighbours.
"""

from __future__ import annotations

import numpy as np

_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
}


def read_ply(path: str) -> dict:
    """Returns {'points': [N,3] float32, 'normals': [N,3] or None}."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii", errors="replace").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = None
        n = 0
        props = []
        in_vertex = False
        for line in header:
            t = line.split()
            if not t:
                continue
            if t[0] == "format":
                fmt = t[1]
            elif t[0] == "element":
                in_vertex = t[1] == "vertex"
                if in_vertex:
                    n = int(t[2])
            elif t[0] == "property" and in_vertex:
                if t[1] == "list":
                    raise ValueError("list property in vertex element")
                props.append((t[2], _DTYPES[t[1]]))
        dt = np.dtype(props)
        if fmt == "ascii":
            rows = []
            for _ in range(n):
                rows.append(tuple(f.readline().split()))
            data = np.array(rows, dtype=None)
            rec = np.zeros(n, dt)
            for i, (name, typ) in enumerate(props):
                rec[name] = data[:, i].astype(typ)
        elif fmt == "binary_little_endian":
            rec = np.frombuffer(f.read(n * dt.itemsize), dtype=dt, count=n)
        elif fmt == "binary_big_endian":
            rec = np.frombuffer(f.read(n * dt.itemsize),
                                dtype=dt.newbyteorder(">"), count=n)
        else:
            raise ValueError(f"unknown ply format {fmt}")
    pts = np.stack([rec["x"], rec["y"], rec["z"]], -1).astype(np.float32)
    names = rec.dtype.names
    normals = None
    if "nx" in names and "ny" in names and "nz" in names:
        normals = np.stack([rec["nx"], rec["ny"], rec["nz"]],
                           -1).astype(np.float32)
    return {"points": pts, "normals": normals}


def write_ply(path: str, points: np.ndarray,
              normals: np.ndarray | None = None) -> None:
    points = np.asarray(points, np.float32)
    n = len(points)
    cols = [points]
    prop = ["property float x", "property float y", "property float z"]
    if normals is not None:
        cols.append(np.asarray(normals, np.float32))
        prop += ["property float nx", "property float ny",
                 "property float nz"]
    header = "\n".join([
        "ply", "format binary_little_endian 1.0",
        f"element vertex {n}", *prop, "end_header", ""])
    body = np.concatenate(cols, axis=1).astype("<f4").tobytes()
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(body)


def estimate_normals(points: np.ndarray, k: int = 16) -> np.ndarray:
    """PCA normals from k nearest neighbors (host-side, scipy KD-tree)."""
    from scipy.spatial import cKDTree
    tree = cKDTree(points)
    _, nbr = tree.query(points, k=min(k, len(points)))
    nb = points[nbr]                       # [N, k, 3]
    nb = nb - nb.mean(1, keepdims=True)
    cov = np.einsum("nki,nkj->nij", nb, nb)
    _, vecs = np.linalg.eigh(cov)
    return vecs[:, :, 0].astype(np.float32)   # smallest eigenvector
