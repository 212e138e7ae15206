"""Build the port's CUDA kernels at first use and bind them with ctypes.

Each source ``src/repro_torch/csrc/<name>.cu`` compiles on its own with

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v \
         -o build/kernels/lib<name>-<hash>.so <name>.cu

into ``build/kernels/`` at the repository root (git-ignored), keyed by a
hash of the source, the shared headers ``csrc/*.cuh`` and the flags, so
an edited source rebuilds and an unchanged one loads at once. The
compiler's output (with ``-Xptxas -v``, each kernel's registers, shared
memory and spills) is kept beside the library as ``lib<name>-<hash>.log``;
``resource_usage`` reads it. Every source has a plain C interface: no
PyTorch headers, which keeps a build to seconds. ``build()`` starts one
``nvcc`` per source, all together, and waits for them.

The C entry points take device pointers and the stream as ``void*`` and
return ``cudaGetLastError()`` after the launch; the wrappers raise when it
is not 0.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def sources() -> list[str]:
    """Names of every kernel source under csrc/."""
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _nvcc() -> str:
    cand = Path(os.environ.get("CUDA_HOME", "/usr/local/cuda")) / "bin" / "nvcc"
    found = str(cand) if cand.exists() else shutil.which("nvcc")
    if not found:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def library_path(name: str) -> Path:
    # the shared headers (csrc/*.cuh) count too: an edited header rebuilds
    parts = [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]
    digest = hashlib.sha256(b"".join(p.read_bytes() for p in parts)
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:16]}.so"


def build(names: list[str] | None = None) -> None:
    """Compile every named source (default: all) that is not built yet,
    one nvcc process per source, all running at once."""
    todo = [n for n in (names or sources()) if not library_path(n).exists()]
    if not todo:
        return
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for name in todo:
        out = library_path(name)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, out, tmp, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
        else:
            out.with_suffix(".log").write_text(log)
            os.replace(tmp, out)          # atomic: concurrent builds agree
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def load(name: str) -> ctypes.CDLL:
    """The built library for csrc/<name>.cu, building it on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(str(library_path(name)))
        return lib


_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_SPILL = re.compile(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                    r"(\d+) bytes spill loads")
_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def resource_usage(name: str) -> list[dict]:
    """Each kernel of the built csrc/<name>.cu as ptxas reported it: the
    (mangled) kernel name, registers a thread, static shared memory, stack
    frame and spill bytes. Empty if the library was built elsewhere."""
    log = library_path(name).with_suffix(".log")
    rows, row = [], None
    for line in (log.read_text().splitlines() if log.exists() else []):
        if m := _ENTRY.search(line):
            row = {"kernel": m.group(1)}
            rows.append(row)
        elif row is not None and (m := _SPILL.search(line)):
            row.update(stack=int(m.group(1)), spill_stores=int(m.group(2)),
                       spill_loads=int(m.group(3)))
        elif row is not None and (m := _USED.search(line)):
            row.update(registers=int(m.group(1)),
                       smem=int(m.group(2) or 0))
    return rows


def check(err: int, what: str) -> None:
    if err:
        raise RuntimeError(f"{what} kernel launch failed: CUDA error {err}")
