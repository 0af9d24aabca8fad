"""Output suite: per-step CSVs, space images, video, TDA and gradient files.

Format-compatible with the reference output layer (``simulation.py:300-460``,
``cell_outputs.py``): same file names, CSV headers (``name[i]`` columns for
vector arrays), PNG step images with black-outlined cells and bottom-left
origin, mp4 video with natural-sorted frames, TDA red/green/all splits, and
gradient CSVs. Rendering uses OpenCV when available and falls back to a
vectorized numpy rasterizer and a standard-library PNG encoder otherwise (no
hard cv2 dependency).
"""

from __future__ import annotations

import csv
import math
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

try:
    import cv2

    HAVE_CV2 = True
except ImportError:
    cv2 = None
    HAVE_CV2 = False

from hipsc_abm.utils.config import check_direct


# ---------------------------------------------------------------------------
# CSV outputs
# ---------------------------------------------------------------------------


def _native_values_csv(
    path: str, header: List[str], data: List[np.ndarray]
) -> bool:
    """C++ fast path for the values CSV (byte-identical to the csv.writer
    path, which stringifies the float64-upcast hstack with CRLF rows).
    Only taken when that upcast would be float64 and no header needs csv
    quoting; returns False to fall back."""
    import ctypes

    from hipsc_abm import native

    lib = native.get_lib()
    if lib is None:
        return False
    if np.result_type(*[a.dtype for a in data]) != np.float64:
        return False  # Python path would emit a different dtype's repr
    if any(ch in h for h in header for ch in (",", '"', "\r", "\n")):
        return False  # csv.writer would quote these
    cols = []
    for a in data:
        for i in range(a.shape[1]):
            cols.append(np.ascontiguousarray(a[:, i], dtype=np.float64))
    nrows = cols[0].shape[0] if cols else 0
    ptrs = (ctypes.c_void_p * len(cols))(
        *[c.ctypes.data for c in cols]
    )
    rc = lib.hipsc_write_values_csv(
        path.encode(), ",".join(header).encode(), nrows, len(cols), ptrs
    )
    return rc == 0


def write_values_csv(
    path: str,
    arrays: Dict[str, np.ndarray],
    order: Sequence[str],
) -> None:
    """Agent-array CSV, one row per agent (``step_values``,
    ``simulation.py:300-347``): 1-D arrays get one column named after the
    array; 2-D arrays get ``name[i]`` columns. Serialized by the native
    writer when available (Python's per-value str() costs seconds per step
    at 500k agents and bounds the async output worker); identical bytes
    either way."""
    header: List[str] = []
    data: List[np.ndarray] = []
    for array_name in order:
        agent_array = np.asarray(arrays[array_name])
        if agent_array.ndim == 1:
            agent_array = agent_array.reshape(-1, 1)
            header.append(array_name)
        else:
            for i in range(agent_array.shape[1]):
                header.append(f"{array_name}[{i}]")
        data.append(agent_array)

    if data and _native_values_csv(path, header, data):
        return
    with open(path, "w", newline="") as file:
        writer = csv.writer(file)
        writer.writerow(header)
        writer.writerows(np.hstack(data))


def merge_sharded_values(dir_path: str, name: str, step: int,
                         out_path: Optional[str] = None,
                         n_shards: Optional[int] = None) -> str:
    """Concatenate per-tile value-CSV shards (ascending tile index) into the
    reference's one-file format. The shards are written by
    ``DomainHipscEngine.write_values_sharded`` — one per tile, each by the
    process that addresses it — so this merge is the only O(colony) I/O
    and runs wherever the single file is actually wanted."""
    import shutil

    pattern = re.compile(
        rf"^{re.escape(name)}_values_{step}\.shard(\d+)\.csv$"
    )
    shards = sorted(
        (int(m.group(1)), f)
        for f in os.listdir(dir_path)
        if (m := pattern.match(f))
    )
    if not shards:
        raise FileNotFoundError(
            f"no {name}_values_{step}.shard*.csv under {dir_path}"
        )
    # a missing tile must fail loudly, not merge into a silently smaller
    # colony (a pod host that died before flushing leaves a gap). Pass
    # n_shards (the engine's tile count) to also catch missing TRAILING
    # shards — without it only interior gaps are detectable.
    indices = [s for s, _ in shards]
    expected = list(range(n_shards if n_shards is not None else len(indices)))
    if indices != expected:
        raise FileNotFoundError(
            f"{name}_values_{step} shard set is incomplete: found {indices}, "
            f"expected {expected} under {dir_path}"
        )
    out_path = out_path or os.path.join(
        dir_path, f"{name}_values_{step}.csv"
    )
    # binary copy: the shards carry the parity writer's CRLF row endings;
    # text mode would rewrite them and break byte-identity with the
    # reference's one-file format
    with open(out_path, "wb") as out:
        for i, (_s, fname) in enumerate(shards):
            with open(os.path.join(dir_path, fname), "rb") as f:
                header = f.readline()
                if i == 0:
                    out.write(header)
                shutil.copyfileobj(f, out)
    return out_path


def _native_savetxt_e18(path: str, matrix: np.ndarray) -> bool:
    """C++ fast path matching ``np.savetxt(fmt='%.18e', delimiter=',')``."""
    from hipsc_abm import native

    lib = native.get_lib()
    if lib is None:
        return False
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    if m.ndim != 2:
        return False
    rc = lib.hipsc_write_matrix_e18(
        path.encode(), m.ctypes.data, m.shape[0], m.shape[1]
    )
    return rc == 0


def _savetxt_csv(path: str, matrix: np.ndarray) -> None:
    if not _native_savetxt_e18(path, matrix):
        np.savetxt(path, matrix, delimiter=",")


def append_data_csv(
    path: str,
    current_step: int,
    number_agents: int,
    step_time: float,
    memory_mb: float,
    method_times: Dict[str, float],
) -> None:
    """Running performance CSV (``data``, ``simulation.py:392-419``)."""
    # header when the file doesn't exist yet, NOT when current_step == 1:
    # under `output_interval` blocks the first data() call lands on a block
    # boundary (e.g. step 4), and the reference's step==1 rule would leave
    # the CSV headerless. (The reference truncates on step 1; appending to
    # a stale file from an aborted same-name run is prevented upstream by
    # check_new_sim, so exists() is the equivalent condition.)
    new_file = not os.path.exists(path)
    with open(path, "a", newline="") as file:
        writer = csv.writer(file)
        if new_file:
            writer.writerow(
                ["Step Number", "Number Cells", "Step Time", "Memory (MB)"]
                + list(method_times.keys())
            )
        writer.writerow(
            [current_step, number_agents, step_time, memory_mb]
            + list(method_times.values())
        )


def process_memory_mb() -> float:
    """RSS of the current process in MB (psutil in the reference; read from
    /proc to avoid the dependency)."""
    try:
        with open("/proc/self/statm") as f:
            rss_pages = int(f.read().split()[1])
        return rss_pages * os.sysconf("SC_PAGE_SIZE") / 1024**2
    except Exception:  # pragma: no cover
        return 0.0


def write_tda_csvs(
    tda_path: str,
    name: str,
    current_step: int,
    locations: np.ndarray,  # (n, >=2)
    gata6: np.ndarray,
    nanog: np.ndarray,
) -> None:
    """Topological-data-analysis location splits (``step_tda``,
    ``cell_outputs.py:102-127``): red = GATA6 > NANOG, green = rest, all."""
    red = gata6 > nanog
    groups = {
        "red": locations[red, 0:2],
        "green": locations[~red, 0:2],
        "all": locations[:, 0:2],
    }
    for key, locs in groups.items():
        path = os.path.join(tda_path, key)
        check_direct(path)
        file_name = f"{name}_tda_{key}_{current_step}.csv"
        _savetxt_csv(os.path.join(path, file_name), locs)


def write_gradient_csvs(
    gradients_path: str,
    name: str,
    current_step: int,
    gradients: Dict[str, np.ndarray],
) -> None:
    """Per-gradient 2D CSVs (``step_gradients``, ``cell_outputs.py:76-100``,
    with the reference's vestigial ``self.paths.separator`` bug fixed)."""
    for gradient_name, grid in gradients.items():
        path = os.path.join(gradients_path, gradient_name)
        check_direct(path)
        file_name = f"{name}_{gradient_name}_{current_step}.csv"
        grid = np.asarray(grid)
        if grid.ndim == 3:
            grid = grid[:, :, 0]
        _savetxt_csv(os.path.join(path, file_name), grid)


# ---------------------------------------------------------------------------
# image rendering
# ---------------------------------------------------------------------------


def _numpy_draw_circles(image, xs, ys, rads, colors):
    """Per-agent reference rasterizer: filled circles with 1px black outline,
    drawn in agent order (later agents overdraw earlier ones, like
    cv2.ellipse). Kept as the semantic oracle for the vectorized path."""
    h, w, _ = image.shape
    for x, y, rad, color in zip(xs, ys, rads, colors):
        r_out = rad + 1
        x0, x1 = max(x - r_out, 0), min(x + r_out + 1, w)
        y0, y1 = max(y - r_out, 0), min(y + r_out + 1, h)
        if x0 >= x1 or y0 >= y1:
            continue
        yy, xx = np.mgrid[y0:y1, x0:x1]
        d2 = (xx - x) ** 2 + (yy - y) ** 2
        patch = image[y0:y1, x0:x1]
        patch[d2 <= r_out**2] = (0, 0, 0)
        patch[d2 <= rad**2] = color
    return image


def _stamp_circles(image, xs, ys, rads, colors):
    """Vectorized circle rasterizer: one scatter per radius class.

    Replaces the per-agent cv2.ellipse loop (the reference's
    ``simulation.py:380-385``), which dominated production wall time at
    scale. Each agent stamps a
    precomputed disk template (black 1px outline ring + colored fill) into
    the flat image with one fancy assignment; NumPy processes scattered
    writes in order, so agent-major ordering reproduces the reference's
    later-agents-overdraw-earlier semantics exactly (validated against
    ``_numpy_draw_circles`` in tests). With heterogeneous radii (growth
    enabled) the per-radius-class passes reorder overdraw BETWEEN classes —
    the drawn pixel sets are identical, only the z-order of overlapping
    different-size cells can differ, which the reference never specifies."""
    h, w, _ = image.shape
    # one sentinel row absorbs out-of-bounds template pixels: cheaper than
    # boolean compaction (no (n, T) mask gathers) and keeps writes agent-major
    flat = np.empty((h * w + 1, 3), np.uint8)
    flat[:-1] = image.reshape(-1, 3)
    for rad in np.unique(rads):
        sel = rads == rad
        x = xs[sel].astype(np.int32)
        y = ys[sel].astype(np.int32)
        col = colors[sel]
        r_out = int(rad) + 1
        span = np.arange(-r_out, r_out + 1, dtype=np.int32)
        dyy, dxx = np.meshgrid(span, span, indexing="ij")
        d2 = dxx * dxx + dyy * dyy
        keep = d2 <= r_out * r_out
        dy, dx = dyy[keep], dxx[keep]  # (T,) template offsets
        is_fill = (d2[keep] <= int(rad) * int(rad))[None, :, None]  # (1, T, 1)

        py = y[:, None] + dy[None, :]  # (n, T)
        px = x[:, None] + dx[None, :]
        ok = (py >= 0) & (py < h) & (px >= 0) & (px < w)
        idx = np.where(ok, py * np.int32(w) + px, np.int32(h * w))
        vals = np.where(is_fill, col[:, None, :], np.uint8(0))  # (n, T, 3)
        # flatten agent-major: later agents' writes land later -> overdraw
        flat[idx.ravel()] = vals.reshape(-1, 3)
    image[:] = flat[:-1].reshape(h, w, 3)
    return image


def render_step_image(
    locations: np.ndarray,  # (n, >=2) um
    radii: np.ndarray,  # (n,) um
    colors: np.ndarray,  # (n, 3) BGR uint8
    size: Tuple[float, float, float],
    image_quality: int,
    background: Tuple[int, int, int] = (0, 0, 0),
    origin_bottom: bool = True,
    method: str = "stamp",
) -> np.ndarray:
    """Render the simulation space (``step_image``, ``simulation.py:349-390``
    / ``cell_outputs.py:12-74``): scale factor from image width, filled
    circle + black outline per cell, optional vertical flip for bottom-left
    origin. ``method``: "stamp" (vectorized, default), "loop" (per-agent
    numpy oracle), or "cv2" (the reference's ellipse loop)."""
    x_size = image_quality
    scale = x_size / size[0]
    y_size = math.ceil(scale * size[1])
    image = np.zeros((y_size, x_size, 3), dtype=np.uint8)
    image[:, :] = background

    xs = (scale * locations[:, 0]).astype(int)
    ys = (scale * locations[:, 1]).astype(int)
    rads = (scale * radii).astype(int)

    if method == "cv2" and HAVE_CV2:
        for x, y, rad, color in zip(xs, ys, rads, colors):
            image = cv2.ellipse(image, (x, y), (rad, rad), 0, 0, 360,
                                tuple(int(c) for c in color), -1)
            image = cv2.ellipse(image, (x, y), (rad, rad), 0, 0, 360, (0, 0, 0), 1)
    elif method == "loop":
        image = _numpy_draw_circles(image, xs, ys, rads, colors)
    else:
        image = _stamp_circles(image, xs, ys, rads, colors)

    if origin_bottom:
        image = image[::-1]
    return np.ascontiguousarray(image)


def hipsc_cell_colors(
    states: np.ndarray,
    gata6: np.ndarray,
    nanog: np.ndarray,
    field: int,
    color_mode: bool,
) -> np.ndarray:
    """BGR cell colors for both reference color modes
    (``cell_outputs.py:41-61``)."""
    n = states.shape[0]
    colors = np.empty((n, 3), dtype=np.uint8)
    if color_mode:
        colors[:] = (32, 252, 22)  # green
        white = (gata6 >= nanog) & (gata6 != 0)
        colors[white] = (255, 255, 255)
    else:
        colors[:] = (32, 252, 22)  # green
        colors[(gata6 == nanog) & (gata6 == 0)] = (255, 50, 50)  # blue
        colors[(gata6 == nanog) & (gata6 == field - 1)] = (30, 255, 255)  # yellow
        colors[gata6 > nanog] = (255, 255, 255)  # white
    colors[states == 1] = (0, 0, 230)  # red overrides everything
    return colors


def encode_png(image: np.ndarray, compression: int = 4) -> bytes:
    """Standard-library PNG encoder for a (h, w, 3) BGR uint8 image: 8-bit
    RGB, filter type 0 on every row, one zlib-compressed IDAT chunk."""
    import struct
    import zlib

    h, w, _ = image.shape
    rgb = np.ascontiguousarray(image[:, :, ::-1], dtype=np.uint8)
    raw = np.zeros((h, 1 + 3 * w), np.uint8)  # leading 0 = no row filter
    raw[:, 1:] = rgb.reshape(h, 3 * w)

    def chunk(tag: bytes, body: bytes) -> bytes:
        crc = zlib.crc32(tag + body) & 0xFFFFFFFF
        return struct.pack(">I", len(body)) + tag + body + struct.pack(">I", crc)

    header = struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + chunk(b"IHDR", header)
            + chunk(b"IDAT", zlib.compress(raw.tobytes(), compression))
            + chunk(b"IEND", b""))


def save_image_png(path: str, image: np.ndarray, compression: int = 4) -> None:
    if HAVE_CV2:
        cv2.imwrite(path, image, [cv2.IMWRITE_PNG_COMPRESSION, compression])
    else:
        with open(path, "wb") as f:
            f.write(encode_png(image, compression))


# ---------------------------------------------------------------------------
# async output pipeline
# ---------------------------------------------------------------------------
#
# Image rendering + PNG encode dominated production wall time at scale. The
# device step needs no host data, so outputs run
# on a single background worker against snapshot arrays while the NEXT device
# step executes — the ABM analog of overlapping host I/O with compute. One
# worker keeps frames strictly ordered; callers flush before reading frames
# back (video assembly) and at loop exit.

_IO_POOL = None
_IO_PENDING: List = []


def submit_output(fn, *args, **kwargs):
    """Run an output task on the background writer thread. Falls back to
    synchronous execution when threads are unavailable.

    Already-completed failed tasks are surfaced here (raised on the next
    submit) so a broken output path aborts the run early instead of only at
    the next flush point."""
    global _IO_POOL
    if _IO_POOL is None:
        from concurrent.futures import ThreadPoolExecutor

        _IO_POOL = ThreadPoolExecutor(max_workers=1, thread_name_prefix="hipsc-io")
    for prev in _IO_PENDING:
        if prev.done() and prev.exception() is not None:
            flush_outputs()  # drains the queue and raises with full context
    fut = _IO_POOL.submit(fn, *args, **kwargs)
    _IO_PENDING.append(fut)
    return fut


def flush_outputs() -> None:
    """Block until every submitted output task finished. Checks EVERY pending
    future: the first worker exception is re-raised, any further failures are
    printed (output errors must not be silently dropped, and later failures
    must not be discarded unchecked behind the first)."""
    global _IO_PENDING
    pending, _IO_PENDING = _IO_PENDING, []
    errors = []
    for fut in pending:
        try:
            fut.result()
        except BaseException as exc:  # noqa: BLE001 — aggregated below
            errors.append(exc)
    if errors:
        for extra in errors[1:]:
            print(f"output worker error (suppressed behind first): {extra!r}")
        raise errors[0]


# ---------------------------------------------------------------------------
# video
# ---------------------------------------------------------------------------


def natural_step_sort(file_list: List[str]) -> List[str]:
    """Sort frame files by their trailing step number
    (``simulation.py:436``)."""
    return sorted(file_list, key=lambda x: int(re.split(r"(\d+)", x)[-2]))


def create_video_from_images(
    images_path: str,
    out_path: str,
    video_quality: int,
    fps: float,
    progress=None,
) -> Optional[str]:
    """Compile step PNGs into an mp4 (``create_video``,
    ``simulation.py:421-460``): natural sort, probe first frame, scale to
    ``video_quality`` width. Falls back to imageio when cv2 is missing, and
    skips the video (returning None) when neither is installed."""
    if not os.path.isdir(images_path):
        return None
    file_list = [f for f in os.listdir(images_path) if f.endswith(".png")]
    if not file_list:
        return None
    file_list = natural_step_sort(file_list)

    if HAVE_CV2:
        first = cv2.imread(os.path.join(images_path, file_list[0]))
        size = first.shape[0:2]
        scale = video_quality / size[1]
        new_size = (video_quality, int(scale * size[0]))
        codec = cv2.VideoWriter_fourcc(*"mp4v")
        video = cv2.VideoWriter(out_path, codec, fps, new_size)
        for i, fname in enumerate(file_list):
            image = cv2.imread(os.path.join(images_path, fname))
            if image.shape[0:2] != (new_size[1], new_size[0]):
                image = cv2.resize(image, new_size, interpolation=cv2.INTER_AREA)
            video.write(image)
            if progress is not None:
                progress(i, len(file_list))
        video.release()
    else:
        try:
            import imageio.v2 as imageio
        except ImportError:
            print(f"no video encoder (cv2 or imageio) installed; skipping {out_path}")
            return None
        with imageio.get_writer(out_path, fps=fps) as writer:
            for i, fname in enumerate(file_list):
                writer.append_data(imageio.imread(os.path.join(images_path, fname)))
                if progress is not None:
                    progress(i, len(file_list))
    return out_path
