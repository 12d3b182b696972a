"""Build and bind the hand-written CUDA kernels in `csrc/`.

Every `csrc/*.cu` is compiled by its own `nvcc` process (all started together)
for `sm_90a` into an object, and the objects are linked into one shared
library with a plain C interface, loaded with `ctypes` (and imported once as
the small launch module below). The build happens at
the first launch, into `_build/` beside this file (listed in `.gitignore`),
under a name derived from the sources' hash (headers included), so an edited
source rebuilds. Nothing here runs when the module is imported.

The launch path. Several of the kernels take a few microseconds of device
time, so what a launch costs on the host sets their time a call (K6 at the
cascade's shape most of all). A launch here is one call into `Kernel`, which
reads PyTorch's current stream (one call, bound once) and calls
`_bags_launch.launch`, a CPython function built into the same library
(`csrc/pylaunch.cu`, the only source that includes Python.h): it puts the
arguments into 8-byte slots and calls the launcher's packed entry
(`csrc/launch.cuh`), whose address ctypes looked up once. No argument goes
through ctypes' conversions at launch time. The wrappers' `check` reads each
tensor's device, dtype, shape and layout once. What is left is the CUDA
runtime's own launch (about 2.5-3.5 us on the card's host) and the output's
allocation.

No `--use_fast_math`; `-fmad=false` keeps every multiply and add rounded on its
own, as the plain PyTorch versions compute them.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import importlib.machinery
import importlib.util
import os
import shutil
import subprocess
import sysconfig
import tempfile
import time
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-fmad=false", "-Xcompiler", "-fPIC",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float

# C symbol -> argument types (the last argument of every launcher is the stream)
SIGNATURES = {
    "bags_nms_keep": (_P, _P, _P, _P, _I, _I, _F, _P),
    "bags_nms_keep_tiled": (_P, _P, _P, _P, _I, _I, _F, _P),
    "bags_nms_keep_gathered": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _F, _P),
    "bags_nms_keep_coords": (_P, _P, _P, _P, _I, _I, _F, _P),
    "bags_gather_lanes": (_P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "bags_roi_align_forward": (
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P,
    ),
    "bags_roi_align_backward": (
        _I, _I, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P,
    ),
    "bags_deform_conv_forward": (
        _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
        _I, _I, _I, _I, _I, _P,
    ),
    "bags_fused_bottleneck": (
        _I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P,
    ),
    "bags_fused_layer": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return str(path)


def build() -> tuple[Path, float]:
    """Compile the kernels if this source version is not built yet.

    Returns (library path, seconds spent building; 0.0 when it was built)."""
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256()
    for src in sorted(CSRC.glob("*.cu*")):
        digest.update(src.name.encode() + src.read_bytes())
    lib = BUILD_DIR / f"libbags_kernels_{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    start = time.perf_counter()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [Path(tmp) / (src.stem + ".o") for src in sources]
        procs = [
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", sysconfig.get_paths()["include"], "-c", str(src), "-o", str(obj)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            for src, obj in zip(sources, objs)
        ]
        logs = [p.communicate()[0] for p in procs]
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name}:\n{log}")
        staged = Path(tmp) / lib.name
        subprocess.run(
            [nvcc, *NVCC_FLAGS, "-shared", *map(str, objs), "-o", str(staged)],
            check=True, capture_output=True, text=True,
        )
        os.replace(staged, lib)
    return lib, time.perf_counter() - start


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, for looking up its launchers' packed entries."""
    return ctypes.CDLL(str(build()[0]))


@functools.cache
def launch_module():
    """`_bags_launch` (csrc/pylaunch.cu), from the same built library: its
    `launch(address, kinds, *args)` makes a launch."""
    path = str(build()[0])
    loader = importlib.machinery.ExtensionFileLoader("_bags_launch", path)
    spec = importlib.util.spec_from_file_location("_bags_launch", path, loader=loader)
    module = importlib.util.module_from_spec(spec)
    loader.exec_module(module)
    return module


def current_stream() -> int:
    """PyTorch's current stream on the current device (device index -1), as
    the raw `cudaStream_t`: what `torch.cuda.current_stream().cuda_stream`
    gives, in one call and without building a Stream object."""
    return torch._C._cuda_getCurrentRawStream(-1)


# the kind of one argument's slot (csrc/pylaunch.cu)
_KIND = {_P: "p", _I: "i", _F: "f"}


class Kernel:
    """One launcher of the shared library, with its count of launches.

    A launch is one call of `_bags_launch.launch` with the address of the
    launcher's packed entry (`<symbol>_packed`, looked up once through
    ctypes at the first launch), the kinds of its arguments (`SIGNATURES`; a
    pointer is an int, 0 for none), the arguments and PyTorch's current
    stream. `launches` rises by one each time the kernel is launched, and
    nowhere else, so a run can show that its path went through the kernel."""

    __slots__ = ("symbol", "launches", "kinds", "address", "launch", "stream")

    def __init__(self, symbol: str):
        self.symbol = symbol
        self.launches = 0
        self.kinds = "".join(_KIND[t] for t in SIGNATURES[symbol]).encode()
        self.address = 0
        self.launch = None

    def bind(self):
        """The launch function, with the packed entry's address (building the
        library if needed)."""
        if self.launch is None:
            self.address = ctypes.cast(getattr(library(), self.symbol + "_packed"), ctypes.c_void_p).value
            self.stream = torch._C._cuda_getCurrentRawStream
            self.launch = launch_module().launch
        return self.launch

    def __call__(self, *args) -> None:
        err = (self.launch or self.bind())(self.address, self.kinds, *args, self.stream(-1))
        if err:
            raise RuntimeError(f"{self.symbol}: CUDA error {err} at launch")
        self.launches += 1


def check(t: torch.Tensor, dtype: torch.dtype, shape: tuple, name: str) -> None:
    """Raise unless `t` is what a kernel takes: contiguous, on the card, of
    this dtype and shape."""
    if not (t.is_cuda and t.dtype is dtype and t.shape == shape and t.is_contiguous()):
        raise ValueError(
            f"{name}: the kernel takes a contiguous CUDA {dtype} tensor of shape "
            f"{tuple(shape)}, got {t.dtype} {tuple(t.shape)} on {t.device} "
            f"(contiguous={t.is_contiguous()})"
        )


NMS_KEEP = Kernel("bags_nms_keep")
NMS_KEEP_GATHERED = Kernel("bags_nms_keep_gathered")
ROI_ALIGN = Kernel("bags_roi_align_forward")
NMS_KEEP_TILED = Kernel("bags_nms_keep_tiled")
ROI_ALIGN_BACKWARD = Kernel("bags_roi_align_backward")
NMS_KEEP_COORDS = Kernel("bags_nms_keep_coords")
GATHER_LANES = Kernel("bags_gather_lanes")
DEFORM_CONV = Kernel("bags_deform_conv_forward")
FUSED_BOTTLENECK = Kernel("bags_fused_bottleneck")
FUSED_LAYER = Kernel("bags_fused_layer")
KERNELS = (
    NMS_KEEP, ROI_ALIGN, NMS_KEEP_GATHERED, NMS_KEEP_TILED, ROI_ALIGN_BACKWARD, NMS_KEEP_COORDS, GATHER_LANES,
    DEFORM_CONV, FUSED_BOTTLENECK, FUSED_LAYER,
)
