"""Mesh IO and the mesh utilities the fitter needs (numpy), copied from
``chore_tpu/utils/meshio.py`` so the port reads and writes the same files
byte for byte: PLY read (ascii and binary little endian) and ascii write,
OBJ read/write, seeded area-weighted surface sampling, PCA axes, the
octasphere stand-in mesh, and the procedural box and chair meshes.
"""
from __future__ import annotations

import numpy as np


def load_ply(path):
    """Read a PLY mesh -> (verts (V,3) f32, faces (F,3) i32 or None)."""
    with open(path, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{path}: not a PLY file")
        fmt = None
        n_verts = n_faces = 0
        vert_props = []
        face_list_types = ("uchar", "int")  # (count, index) declared types
        cur = None
        while True:
            line = f.readline().strip()
            if line.startswith(b"format"):
                fmt = line.split()[1].decode()
            elif line.startswith(b"element vertex"):
                n_verts = int(line.split()[-1])
                cur = "vertex"
            elif line.startswith(b"element face"):
                n_faces = int(line.split()[-1])
                cur = "face"
            elif line.startswith(b"property") and cur == "vertex":
                parts = line.split()  # "property <type> <name>"
                vert_props.append((parts[2].decode(), parts[1].decode()))
            elif line.startswith(b"property list") and cur == "face":
                parts = line.split()  # "property list <cnt> <idx> <name>"
                face_list_types = (parts[2].decode(), parts[3].decode())
            elif line == b"end_header":
                break

        # full PLY scalar-type vocabulary (both the classic and sized
        # spellings): open3d, for one, writes 'property list uchar uint'
        type_map = {"float": "f4", "float32": "f4",
                    "double": "f8", "float64": "f8",
                    "uchar": "u1", "uint8": "u1",
                    "char": "i1", "int8": "i1",
                    "short": "i2", "int16": "i2",
                    "ushort": "u2", "uint16": "u2",
                    "int": "i4", "int32": "i4",
                    "uint": "u4", "uint32": "u4"}
        if fmt == "ascii":
            verts = np.empty((n_verts, len(vert_props)), np.float64)
            for i in range(n_verts):
                verts[i] = [float(x) for x in f.readline().split()]
            faces = []
            for _ in range(n_faces):
                vals = [int(x) for x in f.readline().split()]
                if vals[0] == 3:
                    faces.append(vals[1:4])
                elif vals[0] == 4:
                    faces.append([vals[1], vals[2], vals[3]])
                    faces.append([vals[1], vals[3], vals[4]])
        elif fmt == "binary_little_endian":
            dtype = np.dtype([(n, type_map[t]) for n, t in vert_props])
            data = np.frombuffer(f.read(n_verts * dtype.itemsize), dtype)
            verts = np.stack([data[n] for n, _ in vert_props], axis=1)
            raw = f.read()
            faces = []
            cnt_dt = np.dtype("<" + type_map[face_list_types[0]])
            idx_dt = np.dtype("<" + type_map[face_list_types[1]])
            stride3 = cnt_dt.itemsize + 3 * idx_dt.itemsize
            # fast path: uniform all-triangle face block
            if n_faces > 0 and len(raw) >= stride3 * n_faces:
                fd = np.dtype([("n", cnt_dt), ("v", idx_dt, (3,))])
                block = np.frombuffer(raw[: stride3 * n_faces], fd)
                if (block["n"] == 3).all():
                    faces = block["v"].astype(np.int64)
            if len(faces) == 0:
                off = 0
                for _ in range(n_faces):
                    cnt = int(np.frombuffer(raw, cnt_dt, 1, off)[0])
                    off += cnt_dt.itemsize
                    idx = np.frombuffer(raw, idx_dt, cnt, off).astype(
                        np.int64
                    )
                    off += cnt * idx_dt.itemsize
                    if cnt == 3:
                        faces.append(idx)
                    elif cnt == 4:
                        faces.append([idx[0], idx[1], idx[2]])
                        faces.append([idx[0], idx[2], idx[3]])
        else:
            raise ValueError(f"unsupported PLY format {fmt}")
    xyz = verts[:, :3].astype(np.float32)
    faces = np.asarray(faces, np.int32) if len(faces) else None
    return xyz, faces


def save_ply(path, verts, faces=None, colors=None):
    """Write an ascii PLY (optionally vertex-colored point cloud)."""
    verts = np.asarray(verts)
    n_faces = 0 if faces is None else len(faces)
    with open(path, "w") as f:
        f.write("ply\nformat ascii 1.0\n")
        f.write(f"element vertex {len(verts)}\n")
        f.write("property float x\nproperty float y\nproperty float z\n")
        if colors is not None:
            f.write("property uchar red\nproperty uchar green\nproperty uchar blue\n")
        f.write(f"element face {n_faces}\n")
        f.write("property list uchar int vertex_indices\nend_header\n")
        if colors is not None:
            c = np.clip(np.asarray(colors) * 255, 0, 255).astype(np.uint8)
            for v, col in zip(verts, c):
                f.write(f"{v[0]} {v[1]} {v[2]} {col[0]} {col[1]} {col[2]}\n")
        else:
            for v in verts:
                f.write(f"{v[0]} {v[1]} {v[2]}\n")
        if faces is not None:
            for face in faces:
                f.write(f"3 {face[0]} {face[1]} {face[2]}\n")


def load_obj(path):
    """Read an OBJ mesh -> (verts (V,3) f32, faces (F,3) i32)."""
    verts, faces = [], []
    with open(path) as f:
        for line in f:
            if line.startswith("v "):
                verts.append([float(x) for x in line.split()[1:4]])
            elif line.startswith("f "):
                idx = [int(t.split("/")[0]) - 1 for t in line.split()[1:]]
                for k in range(1, len(idx) - 1):
                    faces.append([idx[0], idx[k], idx[k + 1]])
    return np.asarray(verts, np.float32), np.asarray(faces, np.int32)


def save_obj(path, verts, faces):
    with open(path, "w") as f:
        for v in verts:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        for face in faces:
            f.write(f"f {face[0]+1} {face[1]+1} {face[2]+1}\n")



def sample_surface(verts, faces, n, seed=0):
    """Area-weighted uniform surface sampling (trimesh.sample equivalent)."""
    rng = np.random.RandomState(seed)
    v0, v1, v2 = (verts[faces[:, i]] for i in range(3))
    areas = 0.5 * np.linalg.norm(np.cross(v1 - v0, v2 - v0), axis=1)
    probs = areas / areas.sum()
    fid = rng.choice(len(faces), n, p=probs)
    r1 = np.sqrt(rng.rand(n, 1))
    r2 = rng.rand(n, 1)
    return ((1 - r1) * v0[fid] + r1 * (1 - r2) * v1[fid]
            + r1 * r2 * v2[fid]).astype(np.float32)


def pca_axes(points):
    """(3, 3) principal axes, rows sorted by decreasing variance
    (sklearn PCA .components_ equivalent)."""
    x = points - points.mean(0)
    _, s, vt = np.linalg.svd(x, full_matrices=False)
    return vt.astype(np.float32)


def octasphere(radius=0.2, center=(0, 0, 0), subdiv=2):
    """Subdivided octahedron projected to a sphere -- a dependency-free
    test/stand-in mesh."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], np.float64)
    faces = np.array([[0, 2, 4], [2, 1, 4], [1, 3, 4], [3, 0, 4],
                      [2, 0, 5], [1, 2, 5], [3, 1, 5], [0, 3, 5]])
    for _ in range(subdiv):
        new_faces = []
        verts = list(verts)
        cache = {}

        def mid(i, j):
            k = (min(i, j), max(i, j))
            if k not in cache:
                m = (np.asarray(verts[i]) + np.asarray(verts[j])) / 2
                verts.append(m / np.linalg.norm(m))
                cache[k] = len(verts) - 1
            return cache[k]

        for a, b, c in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [[a, ab, ca], [ab, b, bc], [ca, bc, c], [ab, bc, ca]]
        faces = np.asarray(new_faces)
        verts = np.asarray(verts)
    verts = verts / np.linalg.norm(verts, axis=1, keepdims=True)
    return (verts * radius + np.asarray(center)).astype(np.float32), faces.astype(np.int32)


def box_mesh(size, center=(0, 0, 0), subdiv=0):
    """Axis-aligned box with outward-facing triangles, each face an
    (2^subdiv)^2 grid -- procedural test geometry."""
    sx, sy, sz = (np.asarray(size, np.float64) / 2.0)
    n = 2 ** subdiv
    verts, faces = [], []
    # each face: origin, u-axis, v-axis, with (u x v) pointing outward
    axes = [
        ((-sx, -sy, sz), (2 * sx, 0, 0), (0, 2 * sy, 0)),   # +z
        ((sx, -sy, -sz), (-2 * sx, 0, 0), (0, 2 * sy, 0)),  # -z
        ((sx, -sy, sz), (0, 0, -2 * sz), (0, 2 * sy, 0)),   # +x
        ((-sx, -sy, -sz), (0, 0, 2 * sz), (0, 2 * sy, 0)),  # -x
        ((-sx, sy, sz), (2 * sx, 0, 0), (0, 0, -2 * sz)),   # +y
        ((-sx, -sy, -sz), (2 * sx, 0, 0), (0, 0, 2 * sz)),  # -y
    ]
    for origin, u, v in axes:
        base = len(verts)
        o, u, v = (np.asarray(a, np.float64) for a in (origin, u, v))
        for i in range(n + 1):
            for j in range(n + 1):
                verts.append(o + u * (i / n) + v * (j / n))
        for i in range(n):
            for j in range(n):
                a = base + i * (n + 1) + j
                b, c, d = a + 1, a + (n + 1), a + (n + 1) + 1
                faces += [[a, c, b], [b, c, d]]
    verts = np.asarray(verts, np.float64) + np.asarray(center, np.float64)
    return verts.astype(np.float32), np.asarray(faces, np.int32)


def chair_mesh(subdiv=2):
    """Procedural chair (seat, backrest, 4 legs), centred: a concave
    multi-part template for silhouette-fitting studies. subdiv=2 -> 1,152
    faces, subdiv=3 -> 4,608."""
    parts = [
        box_mesh((0.45, 0.05, 0.45), (0, 0.0, 0), subdiv),        # seat
        box_mesh((0.45, 0.50, 0.05), (0, 0.27, -0.20), subdiv),   # back
        box_mesh((0.05, 0.45, 0.05), (-0.18, -0.25, -0.18), subdiv),
        box_mesh((0.05, 0.45, 0.05), (0.18, -0.25, -0.18), subdiv),
        box_mesh((0.05, 0.45, 0.05), (-0.18, -0.25, 0.18), subdiv),
        box_mesh((0.05, 0.45, 0.05), (0.18, -0.25, 0.18), subdiv),
    ]
    verts = np.concatenate([v for v, _ in parts])
    off, faces = 0, []
    for v, f in parts:
        faces.append(f + off)
        off += len(v)
    faces = np.concatenate(faces)
    verts = verts - verts.mean(0)
    return verts.astype(np.float32), faces.astype(np.int32)
