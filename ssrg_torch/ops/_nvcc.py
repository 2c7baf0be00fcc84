"""Build and load the port's CUDA kernels and its host library.

Each kernel is one source ``ssrg_torch/csrc/<name>.cu`` with a plain C
interface. It is compiled with ``nvcc`` for ``sm_90a`` into
``ssrg_torch/build/lib<name>.so`` (a directory git ignores) at first use and
loaded with ctypes; the kernel's wrapper declares the C entry's argument
types. The host library ``csrc/<name>.cpp`` (OpenMP C++, no device code) is
built the same way by :func:`build_host` with ``c++`` (``$SSRG_TORCH_CXX``
names another compiler; ``$CXX`` is not read, since a system's ``CXX`` may
name a GCC installed without OpenMP's runtime, whose ``-fopenmp`` fails).
Nothing here runs at import: the CPU tests import every module on a
machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import os
import os.path as osp
import shutil
import subprocess
from typing import Callable, Dict, Iterable, Sequence

_PKG_DIR = osp.dirname(osp.dirname(osp.abspath(__file__)))
CSRC_DIR = osp.join(_PKG_DIR, "csrc")
BUILD_DIR = osp.join(_PKG_DIR, "build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
]
# no -march=native: the library may be built on one host and run on another
CXX_FLAGS = ["-O3", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]
CXX_ENV = "SSRG_TORCH_CXX"

_libs: Dict[str, ctypes.CDLL] = {}


def source(name: str, ext: str = ".cu") -> str:
    return osp.join(CSRC_DIR, f"{name}{ext}")


def library_path(name: str) -> str:
    return osp.join(BUILD_DIR, f"lib{name}.so")


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [osp.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for path in candidates:
        if path and osp.exists(path):
            return path
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and /usr/local/cuda/bin); "
        "the port's kernels are built from ssrg_torch/csrc at first use"
    )


def _up_to_date(name: str, ext: str = ".cu") -> bool:
    lib = library_path(name)
    return osp.exists(lib) and osp.getmtime(lib) >= osp.getmtime(source(name, ext))


def build(names: Iterable[str], force: bool = False,
          extra_flags: Sequence[str] = ()) -> Dict[str, str]:
    """Compile each ``csrc/<name>.cu`` that has no up-to-date library, one
    ``nvcc`` process per source, all started together; return the
    compiler's output by name ('' for a library that was up to date)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    for name in names:
        if not force and _up_to_date(name):
            continue
        tmp = f"{library_path(name)}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp, source(name)]
        procs[name] = (cmd, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    logs = {name: "" for name in names}
    failed = []
    for name, (cmd, tmp, proc) in procs.items():
        out, err = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
            continue
        os.replace(tmp, library_path(name))
        logs[name] = out + err
    if failed:
        raise RuntimeError("\n".join(failed))
    return logs


def build_host(name: str, force: bool = False) -> str:
    """Compile the host library ``csrc/<name>.cpp`` with ``c++`` (or
    ``$SSRG_TORCH_CXX``) unless it is up to date; return the compiler's
    output. Raises ``RuntimeError`` with the command and its error output
    when the build fails or the compiler is missing: there is no
    fallback."""
    if not force and _up_to_date(name, ".cpp"):
        return ""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{library_path(name)}.{os.getpid()}.tmp"
    cmd = [os.environ.get(CXX_ENV) or "c++", *CXX_FLAGS, "-o", tmp, source(name, ".cpp")]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True)
    except OSError as exc:
        raise RuntimeError(f"host build failed: {' '.join(cmd)}\n{exc}") from exc
    if proc.returncode != 0:
        raise RuntimeError(f"host build failed ({proc.returncode}): {' '.join(cmd)}\n"
                           f"{proc.stderr}")
    os.replace(tmp, library_path(name))
    return proc.stdout + proc.stderr


def library(name: str, declare: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built first if needed;
    ``declare`` sets the argument and result types of its C entries."""
    lib = _libs.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        declare(lib)
        _libs[name] = lib
    return lib


def check_operands(name: str, **tensors) -> None:
    """Refuse operands a kernel does not take: non-contiguous tensors,
    tensors on different devices, devices other than the CPU and CUDA.
    Refusals raise ``TypeError``, never ``ValueError``: ``prepare`` reads a
    ``ValueError`` as "this graph does not suit the engine" and falls back."""
    for arg, t in tensors.items():
        if not t.is_contiguous():
            raise TypeError(f"{name}: {arg} must be contiguous")
    devices = {str(t.device) for t in tensors.values()}
    if len(devices) != 1:
        raise TypeError(f"{name}: tensors on different devices: {sorted(devices)}")
    dev = next(iter(tensors.values())).device
    if dev.type not in ("cpu", "cuda"):
        raise TypeError(f"{name}: unsupported device {dev}")


def refuse_grad(name: str, why: str, **tensors) -> None:
    """Refuse to run a forward-only kernel where autograd would need its
    gradient: its output, written through a raw pointer, would be cut off
    from the graph. Raises ``RuntimeError`` on every device, so that the CPU
    tests see what the card would do."""
    import torch

    if not torch.is_grad_enabled():
        return
    wanted = sorted(arg for arg, t in tensors.items() if t.requires_grad)
    if wanted:
        raise RuntimeError(f"{name}: no gradient for {', '.join(wanted)}: {why}")


def stream_of(t) -> int:
    """The raw handle of PyTorch's current stream on ``t``'s device."""
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream


def check_launch(name: str, err: int) -> None:
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
