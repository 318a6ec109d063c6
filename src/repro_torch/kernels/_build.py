"""Build the hand-written CUDA kernels and load them with ``ctypes``.

Each ``csrc/<name>.cu`` has a plain C interface (pointers, sizes and the
stream as ``void*``; each entry returns ``cudaGetLastError()``), so it
compiles in seconds with ``nvcc`` alone — no PyTorch headers:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/repro_torch/<name>-<hash>.so

The library lands in ``build/repro_torch/`` at the repository root (listed
in ``.gitignore``), named by a hash of its source, of every shared header
``csrc/*.cuh`` and of the flags, so an edited source or header rebuilds
and an unchanged one loads the library already built.  Nothing links
``libcuda``: the TMA kernels reach its ``cuTensorMapEncodeTiled``
through ``cudaGetDriverEntryPoint`` (``csrc/hopper.cuh``).  The
compiler's report (registers, shared memory, spills) is kept beside it as
``<name>-<hash>.log``.  Nothing builds at import: the first CUDA launch
of a kernel builds it, or :func:`build_all` builds every source at once,
one ``nvcc`` process per source, all started together.
:func:`sass_counts` counts instructions in a built library's machine code
(``cuobjdump --dump-sass``), to show which units a kernel uses, and
:func:`ptxas_report` reads each kernel's registers, spills and static
shared memory from the compiler's report.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import re
import shutil
import subprocess
import threading

import torch

__all__ = ["SOURCES", "CSRC", "BUILD_DIR", "nvcc_path", "build_all", "load",
           "check", "require", "stream_handle", "sass_counts",
           "ptxas_report", "TENSOR_CORE_SASS"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / \
    "repro_torch"
SOURCES = ("matmul", "jacobi", "flash_decode", "black_scholes",
           "flash_attention", "flash_attention_train")

# the kernels that must run on the tensor cores, by source: for each
# kernel (a part of its mangled name), the SASS lines that show it, for
# sass_counts -- wgmma (HGMMA) fed by TMA (UTMALDG) in the bf16 flash
# attention and in the training attention's forward, dQ and dK/dV kernels,
# tf32 tensor-core products in the GEMM and the tile update
_TF32_MMA = {"HMMA.TF32": r"\bHG?MMA\.\S*TF32"}
_WGMMA_TMA = {"HGMMA": r"\bHGMMA\.", "UTMALDG": r"\bUTMALDG\b"}
TENSOR_CORE_SASS = {
    "flash_attention": {"flash_attention_bf16_kernel": _WGMMA_TMA},
    "flash_attention_train": {"attn_train_fwd_kernel": _WGMMA_TMA,
                              "attn_train_dq_kernel": _WGMMA_TMA,
                              "attn_train_dkdv_kernel": _WGMMA_TMA},
    "matmul": {"tile_gemm_3xtf32_kernel": _TF32_MMA,
               "tile_update_3xtf32_kernel": _TF32_MMA},
}

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str | None:
    """``nvcc`` on PATH, else under ``CUDA_HOME`` or ``/usr/local/cuda``."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    return str(cand) if cand.is_file() else None


def _target(name: str, csrc: pathlib.Path = CSRC) -> pathlib.Path:
    """The library of ``csrc/<name>.cu``, named by a digest of the source,
    every shared header ``csrc/*.cuh`` and the flags."""
    h = hashlib.sha256((csrc / f"{name}.cu").read_bytes())
    for header in sorted(csrc.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[pathlib.Path, subprocess.Popen] | None:
    """Start ``nvcc`` for one source unless its library exists."""
    target = _target(name)
    if target.is_file():
        return None
    nvcc = nvcc_path()
    if nvcc is None:
        raise RuntimeError(
            f"cannot build {name}.cu: nvcc not found (PATH, CUDA_HOME or "
            "/usr/local/cuda/bin)")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    log = open(target.with_suffix(".log"), "w", encoding="utf-8")
    proc = subprocess.Popen([nvcc, *NVCC_FLAGS, "-o", str(tmp),
                             str(CSRC / f"{name}.cu")],
                            stdout=log, stderr=subprocess.STDOUT)
    log.close()
    return tmp, proc


def _finish(name: str, tmp: pathlib.Path, proc: subprocess.Popen) -> None:
    rc = proc.wait()
    target = _target(name)
    if rc != 0:
        tmp.unlink(missing_ok=True)
        report = target.with_suffix(".log").read_text(encoding="utf-8")
        raise RuntimeError(f"nvcc failed on {name}.cu (exit {rc}):\n"
                           f"{report}")
    os.replace(tmp, target)       # atomic: concurrent processes agree


def build_all(names=SOURCES) -> dict[str, pathlib.Path]:
    """Build every named source (one ``nvcc`` each, all in parallel) and
    return ``{name: library path}``."""
    with _lock:
        started = {n: _start(n) for n in names}
        errors = []
        for n, job in started.items():
            if job is not None:
                try:
                    _finish(n, *job)
                except RuntimeError as e:
                    errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return {n: _target(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built on first use."""
    lib = _loaded.get(name)
    if lib is None:
        path = build_all((name,))[name]
        with _lock:
            lib = _loaded.get(name)
            if lib is None:
                lib = _loaded[name] = ctypes.CDLL(str(path))
    return lib


# status codes of the C entries besides cudaError_t (csrc/hopper.cuh)
_ENTRY_ERRORS = {-1: "libcuda has no cuTensorMapEncodeTiled",
                 -2: "a TMA tensor map did not encode"}


def check(rc: int, what: str) -> None:
    """Raise if a C entry reported an error: a CUDA error (its
    ``cudaGetLastError``) or a tensor map it could not make."""
    if rc in _ENTRY_ERRORS:
        raise RuntimeError(f"{what}: {_ENTRY_ERRORS[rc]}")
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError {rc}")


def require(x: torch.Tensor, name: str, shape: tuple,
            dtype: torch.dtype = torch.float32,
            device: torch.device | None = None) -> None:
    """Validate one kernel operand before its pointer goes to C: device
    (a CUDA device, ``device`` when given), dtype, exact shape and
    row-major contiguity.  Raises ``ValueError`` on anything the kernel
    does not take."""
    if x.device.type != "cuda" or (device is not None and
                                   x.device != device):
        raise ValueError(f"{name}: expected a tensor on "
                         f"{device or 'a CUDA device'}, got {x.device}")
    if x.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def require_pointerless(*xs: torch.Tensor, dtype: torch.dtype) -> None:
    """What :func:`require` checks of operands that have no pointer
    (``meta`` tensors, a dry run's): dtype and row-major contiguity (the
    wrapper checked the shapes)."""
    for x in xs:
        if x.dtype != dtype:
            raise ValueError(f"expected {dtype}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError("expected a contiguous tensor")


def stream_handle(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the ``void*`` a C entry
    takes."""
    return torch.cuda.current_stream(device).cuda_stream


def _cuobjdump() -> str:
    nvcc = nvcc_path()
    found = shutil.which("cuobjdump") or (
        str(pathlib.Path(nvcc).with_name("cuobjdump")) if nvcc else None)
    if not found or not pathlib.Path(found).is_file():
        raise RuntimeError("cuobjdump not found beside nvcc")
    return found


def sass_counts(name: str, function: str,
                patterns: dict[str, str]) -> dict[str, int]:
    """Instructions of the kernels in ``csrc/<name>.cu``'s library whose
    mangled name contains ``function``: for each key of ``patterns``, the
    number of SASS lines its regular expression matches (built first if
    needed).  Raises if no kernel's name matches."""
    path = build_all((name,))[name]
    dump = subprocess.run([_cuobjdump(), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True,
                          timeout=300).stdout
    counts = dict.fromkeys(patterns, 0)
    matched, inside = False, False
    for line in dump.splitlines():
        head = re.match(r"\s*Function\s*:\s*(\S+)", line)
        if head:
            inside = function in head.group(1)
            matched |= inside
        elif inside:
            for key, pat in patterns.items():
                counts[key] += bool(re.search(pat, line))
    if not matched:
        raise RuntimeError(f"no kernel named *{function}* in {path.name}")
    return counts


def ptxas_report(name: str, function: str) -> dict[str, dict[str, int]]:
    """For each kernel of ``csrc/<name>.cu`` whose mangled name contains
    ``function``: its registers, spill stores and loads (bytes) and static
    shared memory (bytes), from the ``-Xptxas -v`` report kept beside the
    library (built first if needed).  Raises if no kernel's name
    matches."""
    path = build_all((name,))[name]
    report: dict[str, dict[str, int]] = {}
    current = None
    for line in path.with_suffix(".log").read_text(
            encoding="utf-8").splitlines():
        head = re.search(r"Compiling entry function '(\S+)'", line)
        if head:
            current = head.group(1) if function in head.group(1) else None
            if current:
                report[current] = dict(registers=0, spill_stores=0,
                                       spill_loads=0, smem=0)
            continue
        if current is None:
            continue
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                          r"loads", line)
        if spill:
            report[current].update(spill_stores=int(spill.group(1)),
                                   spill_loads=int(spill.group(2)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            report[current]["registers"] = int(used.group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            if smem:
                report[current]["smem"] = int(smem.group(1))
    if not report:
        raise RuntimeError(f"no kernel named *{function}* in "
                           f"{path.with_suffix('.log').name}")
    return report
