"""PLY splat import and export, Inria-3DGS-compatible (port of
brush_tpu/datasets/ply.py; reference: brush-dataset/src/splat_import.rs and
splat_export.rs).

- raw (pre-activation) values on disk: log scales, pre-sigmoid opacity,
  unnormalized wxyz rotations (normalized on import, clamped at 1e-6);
- f_rest_* coefficients stored channel-major ([channel][coeff]) and
  interleaved to [coeff][channel] on import (splat_import.rs:168-181);
- SH truncated to degree 3 on import (splat_import.rs:248-252);
- export: binary little-endian, header property order of
  splat_export.rs:76-95, the live rows only.

The reader is property-order agnostic (reads by name) and supports ascii,
binary little- and big-endian encodings and any scalar type.
"""

from __future__ import annotations

import io

import numpy as np

from brush_tpu_torch.constants import sh_coeffs_for_degree
from brush_tpu_torch.splats import Splats, from_dense

_DTYPES = {
    "float": "f4", "float32": "f4", "double": "f8", "float64": "f8",
    "uchar": "u1", "uint8": "u1", "char": "i1", "int8": "i1",
    "ushort": "u2", "uint16": "u2", "short": "i2", "int16": "i2",
    "uint": "u4", "uint32": "u4", "int": "i4", "int32": "i4",
}

MIN_PROPS = [
    "x", "y", "z", "scale_0", "scale_1", "scale_2", "opacity",
    "rot_0", "rot_1", "rot_2", "rot_3", "f_dc_0", "f_dc_1", "f_dc_2",
]


def _parse_header(data: bytes):
    end = data.find(b"end_header\n")
    if end < 0:
        raise ValueError("Invalid ply: no end_header")
    header = data[:end].decode("ascii", errors="replace")
    body = data[end + len(b"end_header\n"):]

    encoding = None
    elements = []  # (name, count, [(prop_name, type_str)])
    for line in header.splitlines():
        parts = line.strip().split()
        if not parts:
            continue
        if parts[0] == "format":
            encoding = parts[1]
        elif parts[0] == "element":
            elements.append((parts[1], int(parts[2]), []))
        elif parts[0] == "property":
            if parts[1] == "list":
                raise ValueError("List properties unsupported in splat ply")
            elements[-1][2].append((parts[2], parts[1]))
    return encoding, elements, body


def read_ply_vertices(data: bytes) -> dict[str, np.ndarray]:
    """Read the `vertex` element into {property: (n,) float32 array}."""
    encoding, elements, body = _parse_header(data)
    offset = 0
    for name, count, props in elements:
        if encoding == "ascii":
            rows = body.decode("ascii").split("\n")
            vals = np.array(
                [r.split() for r in rows[offset: offset + count]],
                dtype=np.float64)
            offset += count
            if name == "vertex":
                return {p: vals[:, i].astype(np.float32)
                        for i, (p, _t) in enumerate(props)}
        else:
            byte_order = "<" if encoding == "binary_little_endian" else ">"
            dt = np.dtype([(p, byte_order + _DTYPES[t]) for p, t in props])
            if name == "vertex":
                arr = np.frombuffer(body, dtype=dt, count=count,
                                    offset=offset)
                return {p: arr[p].astype(np.float32) for p, _t in props}
            offset += dt.itemsize * count
    raise ValueError("Invalid ply: no vertex element")


def load_splats_from_ply(data: bytes, capacity: int | None = None,
                         device="cuda") -> Splats:
    """Splats from the bytes of a .ply file (splat_import.rs:183-290)."""
    return _verts_to_splats(read_ply_vertices(data), capacity, device)


def load_splats_from_ply_stream(data: bytes, chunk: int = 50_000,
                                capacity: int | None = None, device="cuda"):
    """Progressive import: yield growing Splats every `chunk` vertices.

    Mirrors the reference's chunked emission during .ply loads
    (splat_import.rs:261-280, SPLATS_PER_CHUNK = 50k) so a viewer can show
    partial splats while a large file parses. Binary encodings parse
    incrementally, each chunk once; ascii yields once, at the end.
    """
    encoding, elements, body = _parse_header(data)
    if encoding == "ascii":
        yield load_splats_from_ply(data, capacity, device)
        return
    byte_order = "<" if encoding == "binary_little_endian" else ">"
    offset = 0
    for name, count, props in elements:
        dt = np.dtype([(p, byte_order + _DTYPES[t]) for p, t in props])
        if name != "vertex":
            offset += dt.itemsize * count
            continue
        # Every yield is a full snapshot; the converted chunks accumulate,
        # so the growing prefix is concatenated, never parsed again.
        acc = {pr: [] for pr, _t in props}
        parsed = 0
        for upto in range(min(chunk, count), count + 1, chunk):
            if count - upto < chunk:
                upto = count
            arr = np.frombuffer(
                body, dtype=dt, count=upto - parsed,
                offset=offset + parsed * dt.itemsize,
            )
            for pr, _t in props:
                acc[pr].append(arr[pr].astype(np.float32))
            parsed = upto
            verts = {
                pr: (np.concatenate(v) if len(v) > 1 else v[0])
                for pr, v in acc.items()
            }
            yield _verts_to_splats(verts, capacity, device)
            if upto == count:
                return
    raise ValueError("Invalid ply: no vertex element")


def _verts_to_splats(verts: dict, capacity: int | None,
                     device) -> Splats:
    for p in MIN_PROPS:
        if p not in verts:
            raise ValueError(f"Invalid splat ply. Missing property {p}")

    n = verts["x"].shape[0]
    means = np.stack([verts["x"], verts["y"], verts["z"]], axis=-1)
    log_scales = np.stack(
        [verts["scale_0"], verts["scale_1"], verts["scale_2"]], axis=-1)
    quats = np.stack(
        [verts["rot_0"], verts["rot_1"], verts["rot_2"], verts["rot_3"]],
        axis=-1)
    norms = np.linalg.norm(quats, axis=-1, keepdims=True)
    quats = quats / np.clip(norms, 1e-6, None)

    rest_idx = sorted(
        int(k[len("f_rest_"):]) for k in verts if k.startswith("f_rest_"))
    coeffs_per_channel = ((max(rest_idx) + 1) if rest_idx else 0) // 3
    sh = np.zeros((n, coeffs_per_channel + 1, 3), np.float32)
    for ch in range(3):
        sh[:, 0, ch] = verts[f"f_dc_{ch}"]
        for c in range(coeffs_per_channel):
            sh[:, c + 1, ch] = verts[f"f_rest_{ch * coeffs_per_channel + c}"]
    sh = sh[:, :sh_coeffs_for_degree(3)]

    return from_dense(means, sh, quats, verts["opacity"], log_scales,
                      capacity, device=device)


def splats_to_ply(splats: Splats) -> bytes:
    """(splat_export.rs:67-106). Binary little-endian, Brush property
    order, the n_live live rows; f_rest channel-major."""
    n = int(splats.n_live)
    host = {k: v[:n].detach().cpu().numpy().astype(np.float32)
            for k, v in splats.params().items()}
    sh = host["sh_coeffs"]  # (n, K, 3)
    rest = (sh.shape[1] - 1) * 3

    props = list(MIN_PROPS) + [f"f_rest_{i}" for i in range(rest)]
    header = (
        "ply\nformat binary_little_endian 1.0\n"
        "comment Exported from brush_tpu_torch\ncomment Vertical axis: y\n"
        f"element vertex {n}\n"
        + "".join(f"property float {p}\n" for p in props)
        + "end_header\n"
    )

    out = np.empty((n, len(props)), np.float32)
    out[:, 0:3] = host["means"]
    out[:, 3:6] = host["log_scales"]
    out[:, 6] = host["raw_opacity"]
    out[:, 7:11] = host["quats"]
    out[:, 11:14] = sh[:, 0, :]
    if rest:
        # channel-major: [ch][coeff] (splat_export.rs:36-46).
        out[:, 14:] = sh[:, 1:, :].transpose(0, 2, 1).reshape(n, rest)

    buf = io.BytesIO()
    buf.write(header.encode("ascii"))
    buf.write(out.tobytes())
    return buf.getvalue()
