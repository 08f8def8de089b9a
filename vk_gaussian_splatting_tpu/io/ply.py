"""3DGS PLY reader/writer.

Replaces miniply + the reference's property extraction
(ply_loader_async.cpp:357-445): reads the INRIA 3DGS vertex layout
(x y z [nx ny nz] f_dc_0..2 f_rest_0..44 opacity scale_0..2 rot_0..3) from
binary little-endian or ascii PLY via one numpy structured-dtype read — the
whole payload parses as a single vectorized view, no per-row loop (the
host-side analog of miniply's speed).

Like the reference, coordinates convert RDF (PLY) -> RUB on load
(ply_loader_async.cpp:440, splat_set.h:78).
"""

from __future__ import annotations

import io as _io

import numpy as np

from vk_gaussian_splatting_tpu.scene.splat_set import CoordinateSystem, SplatSet

_PLY_DTYPES = {
    "float": "<f4", "float32": "<f4", "double": "<f8", "float64": "<f8",
    "int": "<i4", "int32": "<i4", "uint": "<u4", "uint32": "<u4",
    "short": "<i2", "int16": "<i2", "ushort": "<u2", "uint16": "<u2",
    "char": "i1", "int8": "i1", "uchar": "u1", "uint8": "u1",
}


def _parse_header(f) -> tuple[str, int, list[tuple[str, str]], int]:
    """Returns (format, vertex_count, [(name, dtype)], header_len)."""
    magic = f.readline().strip()
    if magic != b"ply":
        raise ValueError("not a PLY file")
    fmt = None
    props: list[tuple[str, str]] = []
    count = 0
    in_vertex = False
    while True:
        line = f.readline()
        if not line:
            raise ValueError("unexpected EOF in PLY header")
        tokens = line.decode("ascii", "replace").strip().split()
        if not tokens:
            continue
        if tokens[0] == "format":
            fmt = tokens[1]
        elif tokens[0] == "element":
            in_vertex = tokens[1] == "vertex"
            if in_vertex:
                count = int(tokens[2])
        elif tokens[0] == "property" and in_vertex:
            if tokens[1] == "list":
                raise ValueError("list properties unsupported in vertex element")
            props.append((tokens[-1], _PLY_DTYPES[tokens[1]]))
        elif tokens[0] == "end_header":
            break
    if fmt not in ("binary_little_endian", "ascii"):
        raise ValueError(f"unsupported PLY format: {fmt}")
    return fmt, count, props, f.tell()


def load_ply(path: str, to_rub: bool = True) -> SplatSet:
    from vk_gaussian_splatting_tpu import native

    with open(path, "rb") as f:
        fmt, n, props, offset = _parse_header(f)
        names = [p[0] for p in props]
        dtype = np.dtype(props)
        all_f32 = all(d == "<f4" for _, d in props)
        if (fmt == "binary_little_endian" and all_f32 and native.available()
                and _groups_contiguous(names)):
            # native multithreaded extraction (the miniply analog)
            payload = np.fromfile(f, dtype=np.uint8,
                                  count=n * dtype.itemsize)
            return _from_native(payload, n, names, dtype.itemsize, to_rub)
        if fmt == "binary_little_endian":
            data = np.fromfile(f, dtype=dtype, count=n)
        else:
            flat = np.loadtxt(_io.TextIOWrapper(f, "ascii"), dtype=np.float64,
                              max_rows=n).reshape(n, len(props))
            data = np.zeros(n, dtype=dtype)
            for i, name in enumerate(names):
                data[name] = flat[:, i]

    def cols(prefix, k):
        return np.stack(
            [data[f"{prefix}{i}"].astype(np.float32) for i in range(k)], axis=1
        )

    means = np.stack([data[a].astype(np.float32) for a in "xyz"], axis=1)
    sh_dc = cols("f_dc_", 3) if "f_dc_0" in names else np.zeros((n, 3), np.float32)
    opac = (data["opacity"].astype(np.float32) if "opacity" in names
            else np.zeros(n, np.float32))
    scales = cols("scale_", 3) if "scale_0" in names else np.full((n, 3), -8.0, np.float32)
    quats = cols("rot_", 4) if "rot_0" in names else np.tile(
        np.array([1, 0, 0, 0], np.float32), (n, 1))

    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    m = n_rest // 3
    if n_rest:
        # PLY layout is channel-major ([R: m coeffs][G: m][B: m]); our SplatSet
        # is coefficient-major with RGB per coefficient.
        rest_flat = cols("f_rest_", n_rest)                  # (n, 3*m)
        sh_rest = rest_flat.reshape(n, 3, m).transpose(0, 2, 1)
    else:
        sh_rest = np.zeros((n, 0, 3), np.float32)

    splats = SplatSet(
        means=means, scales=scales, quats=quats, opacities=opac,
        sh_dc=sh_dc, sh_rest=np.ascontiguousarray(sh_rest),
    )
    if to_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RDF, CoordinateSystem.RUB)
    return splats


def _from_native(payload: np.ndarray, n: int, names: list[str], stride: int,
                 to_rub: bool) -> SplatSet:
    """One-pass extraction + SH repack through native/fast_splats.cpp."""
    from vk_gaussian_splatting_tpu import native

    byte_off = {nm: i * 4 for i, nm in enumerate(names)}
    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    m = n_rest // 3
    if n_rest and not _contiguous_rest(names):
        raise ValueError("non-contiguous f_rest properties")

    def off_of(group):
        return byte_off.get(group, -1)

    offsets = ([byte_off["x"]] * 3
               if False else [byte_off["x"], byte_off["y"], byte_off["z"]])
    offsets += [off_of("f_dc_0"), -1, -1]
    offsets += [off_of("opacity")]
    offsets += [off_of("scale_0"), -1, -1]
    offsets += [off_of("rot_0"), -1, -1, -1]
    offsets += [off_of("f_rest_0")]
    means, sh_dc, opac, scales, quats, sh_rest = native.ply_extract_3dgs(
        payload, n, stride, offsets, m)

    splats = SplatSet(means=means, scales=scales, quats=quats, opacities=opac,
                      sh_dc=sh_dc, sh_rest=sh_rest)
    if to_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RDF,
                                            CoordinateSystem.RUB)
    return splats


def _groups_contiguous(names: list[str]) -> bool:
    """The native extractor memcpys each group (xyz, f_dc, scale, rot,
    f_rest) as one contiguous 12/16-byte run from its head offset; a valid
    PLY may reorder properties, which would parse silently as garbage.
    Gate the fast path on every group actually being consecutive."""
    def run(group: list[str]) -> bool:
        if group[0] not in names:
            return True  # absent group: extractor gets offset -1 (defaults)
        i0 = names.index(group[0])
        return names[i0:i0 + len(group)] == group

    groups = [["x", "y", "z"],
              [f"f_dc_{i}" for i in range(3)],
              [f"scale_{i}" for i in range(3)],
              [f"rot_{i}" for i in range(4)]]
    return all(run(g) for g in groups) and (
        not any(p.startswith("f_rest_") for p in names)
        or _contiguous_rest(names))


def _contiguous_rest(names: list[str]) -> bool:
    try:
        i0 = names.index("f_rest_0")
    except ValueError:
        return False
    n_rest = sum(1 for p in names if p.startswith("f_rest_"))
    return names[i0:i0 + n_rest] == [f"f_rest_{i}" for i in range(n_rest)]


def save_ply(path: str, splats: SplatSet, from_rub: bool = True) -> None:
    """Writes the INRIA binary layout (the reverse of load_ply)."""
    if from_rub:
        splats = splats.convert_coordinates(CoordinateSystem.RUB, CoordinateSystem.RDF)
    n = int(np.asarray(splats.means).shape[0])
    m = int(np.asarray(splats.sh_rest).shape[1])
    names = (["x", "y", "z"]
             + [f"f_dc_{i}" for i in range(3)]
             + [f"f_rest_{i}" for i in range(3 * m)]
             + ["opacity"]
             + [f"scale_{i}" for i in range(3)]
             + [f"rot_{i}" for i in range(4)])
    dtype = np.dtype([(nm, "<f4") for nm in names])
    rec = np.zeros(n, dtype=dtype)
    means = np.asarray(splats.means, np.float32)
    for i, a in enumerate("xyz"):
        rec[a] = means[:, i]
    sh_dc = np.asarray(splats.sh_dc, np.float32)
    for i in range(3):
        rec[f"f_dc_{i}"] = sh_dc[:, i]
    if m:
        rest = np.asarray(splats.sh_rest, np.float32).transpose(0, 2, 1).reshape(n, 3 * m)
        for i in range(3 * m):
            rec[f"f_rest_{i}"] = rest[:, i]
    rec["opacity"] = np.asarray(splats.opacities, np.float32)
    scales = np.asarray(splats.scales, np.float32)
    quats = np.asarray(splats.quats, np.float32)
    for i in range(3):
        rec[f"scale_{i}"] = scales[:, i]
    for i in range(4):
        rec[f"rot_{i}"] = quats[:, i]

    header = ["ply", "format binary_little_endian 1.0",
              f"element vertex {n}"]
    header += [f"property float {nm}" for nm in names]
    header += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(header).encode("ascii"))
        rec.tofile(f)
