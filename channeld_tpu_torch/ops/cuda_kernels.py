"""Hand-written CUDA kernels for the spatial hot path (Hopper, sm_90a).

The counterpart of ``channeld_tpu/ops/pallas_kernels.py``, which holds
the JAX package's only two TPU kernels. Each kernel here has:

- its CUDA C++ source under ``csrc/`` (the note at the top of each file
  names the TPU kernel it replaces, what bounds it on the H100, and how
  its design answers that);
- a wrapper that checks device, dtype, shape and contiguity, launches
  the kernel on PyTorch's current stream for CUDA tensors (raising if
  the launch fails, never falling back), and takes the plain version
  only for CPU tensors; for CUDA tensors it runs a ``Launch`` from its
  ``prepare_*`` function (the bare C entry with its arguments, which
  chip_smoke.py also times back to back);
- a plain PyTorch version (``*_plain``), used by the CPU path and held
  against the kernel on the card;
- a launch count, ``<wrapper>.launches``, a plain integer raised by one
  per kernel launch and nowhere else.

Build: route (b) of the Hopper guide. At first use, ``build()`` runs one
``nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false -shared``
per source, all started together, into ``build/channeld_tpu_torch/``
at the repository root, cached by a hash of the sources and flags, and
loads each shared library with ctypes (plain C interface, no PyTorch
headers). Nothing is built or imported from CUDA when this module is
imported.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, NamedTuple, Optional

import torch

from .spatial_ops import (
    QuerySet,
    aoi_geometry,
    apply_spots_block,
    apply_spots_overlay,
    assign_cells,
    cell_counts,
    num_cells,
    reciprocal,
    sqrt_rn,
)

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "channeld_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_HEADERS = ("common.cuh",)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float


class KernelSpec(NamedTuple):
    name: str
    source: str  # file under csrc/
    replaces: str  # the TPU kernel, file:line
    symbol: str  # the C launch function
    argtypes: tuple


KERNEL_SPECS = (
    KernelSpec(
        "assign_count", "assign_count.cu",
        "channeld_tpu/ops/pallas_kernels.py:33", "chtpu_assign_count",
        (_P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _P, _P, _P, _I, _I, _I, _P),
    ),
    KernelSpec(
        "aoi", "aoi.cu",
        "channeld_tpu/ops/pallas_kernels.py:109", "chtpu_aoi",
        (_P, _P, _P, _P, _P, _I, _F, _F, _F, _F, _F, _F, _I, _I, _F, _I, _I, _P, _P, _I, _P),
    ),
)

_libs: dict[str, ctypes.CDLL] = {}
_build_lock = threading.Lock()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    path = os.path.join(cuda_home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the CUDA kernels cannot be built")
    return path


def _library_path(spec: KernelSpec) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in (spec.source, *_HEADERS):
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"{spec.name}-{h.hexdigest()[:16]}.so"


def build() -> dict[str, str]:
    """Build (or find in the cache) and load every kernel library.

    Returns {kernel name: nvcc's output} for the kernels compiled by this
    call (ptxas reports registers, shared memory and spills per kernel).
    Raises RuntimeError with the compiler's output if a build fails."""
    with _build_lock:
        todo = [s for s in KERNEL_SPECS if s.name not in _libs]
        if not todo:
            return {}
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = {}
        for spec in todo:
            out = _library_path(spec)
            if out.exists():
                continue
            tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / spec.source)]
            procs[spec.name] = (
                subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True),
                tmp, out,
            )
        logs = {}
        failed = []
        for name, (proc, tmp, out) in procs.items():
            logs[name] = proc.communicate()[0]
            if proc.returncode != 0:
                failed.append(f"{name} (nvcc exit {proc.returncode}):\n{logs[name]}")
            else:
                os.replace(tmp, out)
        if failed:
            raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
        for spec in todo:
            lib = ctypes.CDLL(str(_library_path(spec)))
            fn = getattr(lib, spec.symbol)
            fn.argtypes = list(spec.argtypes)
            fn.restype = ctypes.c_int
            lib.chtpu_error_string.argtypes = [ctypes.c_int]
            lib.chtpu_error_string.restype = ctypes.c_char_p
            lib.chtpu_device_info.argtypes = [_I, ctypes.POINTER(_I), ctypes.POINTER(_I)]
            lib.chtpu_device_info.restype = _I
            _libs[spec.name] = lib
        return logs


def _lib(name: str) -> ctypes.CDLL:
    if name not in _libs:
        build()
    return _libs[name]


def _check_launch(lib: ctypes.CDLL, name: str, err: int) -> None:
    if err != 0:
        msg = lib.chtpu_error_string(err).decode(errors="replace")
        raise RuntimeError(f"CUDA kernel {name} failed to launch: {msg} ({err})")


class Launch(NamedTuple):
    """One prepared kernel launch: the bare C entry, its arguments, and
    the outputs it writes. ``run()`` launches once on the stream that was
    current when it was prepared and raises if the launch fails; the
    wrappers run it once, chip_smoke.py runs it back to back to time the
    kernel without the wrapper between launches (a second run does the
    same work again; K1's counts then hold the sum of both runs, so only
    a wrapper's single run gives counts to use)."""

    name: str
    lib: ctypes.CDLL
    fn: Callable[..., int]
    args: tuple
    outputs: tuple
    launched: Optional[Callable[[], None]] = None  # bookkeeping after a launch

    def run(self) -> None:
        _check_launch(self.lib, self.name, self.fn(*self.args))
        if self.launched is not None:
            self.launched()


def _check(t: torch.Tensor, name: str, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    """Validate one kernel argument; ``None`` in ``shape`` is any size."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != len(shape) or any(
        want is not None and got != want for got, want in zip(t.shape, shape)
    ):
        raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _grid_args(grid) -> tuple:
    """The grid as the kernels take it (csrc/common.cuh SpatialGrid),
    followed by the float32 reciprocal of the cell diagonal."""
    return _grid_args_of(float(grid.offset_x), float(grid.offset_z), float(grid.cell_w),
                         float(grid.cell_h), int(grid.cols), int(grid.rows))


@functools.lru_cache(maxsize=64)
def _grid_args_of(offset_x, offset_z, cell_w, cell_h, cols, rows) -> tuple:
    diag = float((cell_w**2 + cell_h**2) ** 0.5)
    return (offset_x, offset_z, cell_w, cell_h, reciprocal(cell_w), reciprocal(cell_h),
            cols, rows, reciprocal(diag))


def _current_stream(device: torch.device) -> int:
    """The raw handle of PyTorch's current stream on a CUDA device (what
    ``torch.cuda.current_stream(device).cuda_stream`` gives, without
    building a Stream object per launch)."""
    return torch._C._cuda_getCurrentRawStream(device.index)


def _device_kind(device: torch.device) -> str:
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"unsupported device {device}")
    return device.type


_device_info: dict[int, tuple[int, int]] = {}


def device_info(device: torch.device) -> tuple[int, int]:
    """(SM count, largest shared memory one block may opt in to) of a
    CUDA device, queried once per device and passed to every launch."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    if index not in _device_info:
        lib = _lib("assign_count")
        sms, smem = _I(0), _I(0)
        _check_launch(lib, "device query",
                      lib.chtpu_device_info(index, ctypes.byref(sms), ctypes.byref(smem)))
        _device_info[index] = (sms.value, smem.value)
    return _device_info[index]


# ---- K1: fused cell assignment + occupancy histogram ---------------------


def uses_shared_histogram(grid, device: torch.device) -> bool:
    """Whether K1 keeps a per-block histogram in shared memory (else it
    adds straight to the global counts): the bins must fit a block."""
    return 4 * num_cells(grid) <= device_info(device)[1]


# K1's counts buffers, one per (device index, raw stream handle, bins):
# each is zero on the device once the launch that zeroed it has run, and
# only launches on that stream are ordered after it.
_zeroed: dict[tuple[int, int, int], torch.Tensor] = {}


def _counts_pair(device: torch.device, stream: int, bins: int):
    """(counts, next, done) for K1's next launch on ``stream``. ``counts``
    is zero: the previous launch on this stream zeroed it, or it is made
    with torch.zeros (the first launch of a stream and bin count, or the
    one after a launch that failed). ``next`` is new, and the launch
    zeroes it for the launch after; ``done()``, called once the launch
    has been queued, hands it on."""
    key = (device.index, stream, bins)
    counts = _zeroed.pop(key, None)
    if counts is None:
        counts = torch.zeros(bins, dtype=torch.int32, device=device)
    nxt = torch.empty(bins, dtype=torch.int32, device=device)
    return counts, nxt, lambda: _zeroed.__setitem__(key, nxt)


def assign_and_count_plain(grid, positions: torch.Tensor, valid: torch.Tensor):
    """Plain PyTorch K1: (cell_of i32[N], counts i32[C])."""
    cell = assign_cells(grid, positions, valid)
    return cell, cell_counts(cell, num_cells(grid))


def assign_and_count(grid, positions: torch.Tensor, valid: torch.Tensor):
    """Fused cell assignment + occupancy histogram.

    positions f32[N,3], valid bool[N] -> (cell_of i32[N], counts i32[C]).
    The CUDA kernel for CUDA tensors, the plain version for CPU tensors.

    On CUDA the kernel adds into a ``counts`` buffer that the previous
    launch on the same stream zeroed (so no zero-fill is launched), and
    zeroes the buffer of the next. That holds because every launch on a
    stream goes through this wrapper, in stream order, once each. So:
    raises under CUDA-graph capture (a replay would add to the counts of
    the last one); the returned ``counts`` belongs to the caller; a raw
    stream handle must not be reused by another stream while its last
    launch may be pending (PyTorch's own streams never are)."""
    dev = positions.device
    n = positions.shape[0] if positions.dim() == 2 else -1
    _check(positions, "positions", torch.float32, (None, 3), dev)
    _check(valid, "valid", torch.bool, (n,), dev)
    if _device_kind(dev) == "cpu":
        return assign_and_count_plain(grid, positions, valid)
    launch = prepare_assign_count(grid, positions, valid)
    launch.run()
    assign_and_count.launches += 1
    return launch.outputs


assign_and_count.launches = 0


def prepare_assign_count(grid, positions: torch.Tensor, valid: torch.Tensor) -> Launch:
    """K1's launch on CUDA tensors that ``assign_and_count`` has checked:
    allocates (cell_of, counts) and returns the bare launch. Raises under
    CUDA-graph capture (see ``assign_and_count``)."""
    if torch.cuda.is_current_stream_capturing():
        raise RuntimeError("assign_and_count cannot be captured in a CUDA graph: each "
                           "launch takes counts that the previous launch zeroed")
    dev = positions.device
    n, c = positions.shape[0], num_cells(grid)
    if n >= 2**31 or c >= 2**24:
        raise ValueError(f"{n} slots x {c} cells exceeds the kernel's int32 indexing")
    lib = _lib("assign_count")
    stream = _current_stream(dev)
    counts, nxt, done = _counts_pair(dev, stream, c)
    cell_of = torch.empty(n, dtype=torch.int32, device=dev)
    args = (positions.data_ptr(), valid.data_ptr(), n, *_grid_args(grid)[:8],
            cell_of.data_ptr(), counts.data_ptr(), nxt.data_ptr(),
            int(uses_shared_histogram(grid, dev)), device_info(dev)[0], dev.index, stream)
    return Launch("assign_count", lib, lib.chtpu_assign_count, args, (cell_of, counts), done)


# ---- K2: AOI interest + damping distance ---------------------------------


def aoi_tile_plain(grid, kind, center, extent, direction, cos_angle,
                   cell_base: int = 0, cell_count: Optional[int] = None):
    """Plain PyTorch K2 over the global cell ids [cell_base,
    cell_base + cell_count): (hit bool[Q,Cb], dist i32[Q,Cb])."""
    if cell_count is None:
        cell_count = num_cells(grid) - cell_base
    ids = torch.arange(cell_base, cell_base + cell_count, dtype=torch.int32,
                       device=kind.device)
    return aoi_geometry(grid, kind, center, extent, direction, cos_angle, ids)


def sqrt_threshold(r: torch.Tensor) -> torch.Tensor:
    """The torch twin of ``sqrt_threshold`` in csrc/aoi.cu: per element,
    the largest float32 s with sqrt(s) <= r (IEEE sqrt, ``sqrt_rn``), so
    that (sqrt(s) <= r) == (s <= sqrt_threshold(r)) for every s >= 0 and
    every NaN s. NaN and +inf give themselves, r < 0 gives -1 (nothing
    passes). K2 tests a sphere or cone against it instead of taking a
    root of the rectangle distance."""
    r = r.to(torch.float32)
    inf = torch.full_like(r, float("inf"))
    search = (r >= 0) & (r < inf)
    t = r * r  # within an ulp or two of the answer
    while True:
        down = search & (t > 0) & (sqrt_rn(t) > r)
        if not bool(down.any()):
            break
        t = torch.where(down, torch.nextafter(t, torch.zeros_like(t)), t)
    while True:
        up = torch.nextafter(t, inf)
        step = search & (sqrt_rn(up) <= r)
        if not bool(step.any()):
            break
        t = torch.where(step, up, t)
    return torch.where(search, t, torch.where(r < 0, -1.0, r))


def aoi_tile(grid, kind, center, extent, direction, cos_angle,
             cell_base: int = 0, cell_count: Optional[int] = None):
    """Geometric AOI pass over the global cell ids [cell_base,
    cell_base + cell_count) (default: the whole grid).

    kind i32[Q], center/extent/direction f32[Q,2], cos_angle f32[Q] ->
    (hit bool[Q,Cb], dist i32[Q,Cb]). The CUDA kernel for CUDA tensors,
    the plain version for CPU tensors."""
    dev = kind.device
    q = kind.shape[0] if kind.dim() == 1 else -1
    _check(kind, "kind", torch.int32, (q,), dev)
    for name, t in (("center", center), ("extent", extent), ("direction", direction)):
        _check(t, name, torch.float32, (q, 2), dev)
    _check(cos_angle, "cos_angle", torch.float32, (q,), dev)
    if cell_count is None:
        cell_count = num_cells(grid) - cell_base
    if cell_base < 0 or cell_count < 0 or cell_base + cell_count >= 2**31:
        raise ValueError(f"bad cell block [{cell_base}, {cell_base}+{cell_count})")
    if _device_kind(dev) == "cpu":
        return aoi_tile_plain(grid, kind, center, extent, direction, cos_angle,
                              cell_base, cell_count)
    launch = prepare_aoi(grid, kind, center, extent, direction, cos_angle,
                         cell_base, cell_count)
    launch.run()
    aoi_tile.launches += 1
    return launch.outputs


aoi_tile.launches = 0


def prepare_aoi(grid, kind, center, extent, direction, cos_angle,
                cell_base: int, cell_count: int) -> Launch:
    """K2's launch on CUDA tensors that ``aoi_tile`` has checked:
    allocates (hit, dist) and returns the bare launch."""
    dev = kind.device
    q = kind.shape[0]
    lib = _lib("aoi")
    hit = torch.empty((q, cell_count), dtype=torch.bool, device=dev)
    dist = torch.empty((q, cell_count), dtype=torch.int32, device=dev)
    args = (kind.data_ptr(), center.data_ptr(), extent.data_ptr(), direction.data_ptr(),
            cos_angle.data_ptr(), q, *_grid_args(grid), cell_base, cell_count,
            hit.data_ptr(), dist.data_ptr(), dev.index,
            _current_stream(dev))
    return Launch("aoi", lib, lib.chtpu_aoi, args, (hit, dist))


def aoi_masks_cuda(grid, queries: QuerySet):
    """The counterpart of ``aoi_masks_pallas``: the same (interest
    bool[Q,C], dist i32[Q,C]) as ``spatial_ops.aoi_masks``. cos(angle)
    is taken once per query on the queries' device; the spots-table
    overlay is applied after the kernel, as on the TPU."""
    hit, dist = aoi_tile(
        grid, queries.kind, queries.center, queries.extent,
        queries.direction, torch.cos(queries.angle),
    )
    return apply_spots_overlay(hit, dist, queries)


def aoi_block_cuda(grid, queries: QuerySet, cell_base: int, cell_count: int,
                   spot_dist_slice=None):
    """The counterpart of ``aoi_masks_for_cells`` over the block of global
    cell ids [cell_base, cell_base + cell_count), which may run past the
    grid into padding ids (never interested): K2 over the block, then
    the spots overlay of the table's ``[Q, cell_count]`` slice. The
    cell-sharded plane's per-shard AOI."""
    hit, dist = aoi_tile(
        grid, queries.kind, queries.center, queries.extent,
        queries.direction, torch.cos(queries.angle), cell_base, cell_count,
    )
    if spot_dist_slice is None:
        return hit, dist
    ids = torch.arange(cell_base, cell_base + cell_count, dtype=torch.int32,
                       device=queries.kind.device)
    return apply_spots_block(grid, hit, dist, queries.kind, ids, spot_dist_slice)


# ---- what chip_smoke.py and the tests read -------------------------------

WRAPPERS = {"assign_count": assign_and_count, "aoi": aoi_tile}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in WRAPPERS.items()}
