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

A generated source (``kernels/nitrogen_codegen.py``: one an index, with
the index's separators as literals) takes ``build_generated``: the text
is written as ``build/kernels/<stem>-<hash>.cu``, keyed by a hash of the
text, the headers ``csrc/*.cuh`` and ``CUBIN_FLAGS``, and compiled into a
cubin (device code only, the same code-generation flags, ``-I csrc``)
beside its ``.log``; ``kernels/_driver.py`` loads it. The source, the
cubin and the log are each written under a name of their own process and
thread and renamed into place, so processes that build the same index at
once (xdist workers, the ranks of the sharded index) agree.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
# a generated source: the same device code generation, as a cubin
CUBIN_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xptxas", "-v", "-cubin")

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


def _digest(text: bytes, flags: tuple = NVCC_FLAGS) -> str:
    # the shared headers (csrc/*.cuh) count too: an edited header rebuilds
    headers = b"".join(p.read_bytes() for p in sorted(CSRC.glob("*.cuh")))
    return hashlib.sha256(text + headers
                          + " ".join(flags).encode()).hexdigest()[:16]


def library_path(name: str) -> Path:
    digest = _digest((CSRC / f"{name}.cu").read_bytes())
    return BUILD_DIR / f"lib{name}-{digest}.so"


def generated_path(stem: str, text: str) -> Path:
    """Where the cubin of a generated source lives once built."""
    return BUILD_DIR / f"{stem}-{_digest(text.encode(), CUBIN_FLAGS)}.cubin"


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


def _own(path: Path) -> Path:
    """A name for ``path`` that no other process or thread writes."""
    return path.with_name(
        f"{path.stem}.{os.getpid()}.{threading.get_ident()}.tmp{path.suffix}")


def build_generated(stem: str, text: str) -> tuple[Path, float, bytes]:
    """The cubin of a generated CUDA source, built on first use: (its
    path, the seconds nvcc took: 0.0 when it was built already, the
    cubin's bytes)."""
    out = generated_path(stem, text)
    with _lock:
        try:
            return out, 0.0, out.read_bytes()
        except FileNotFoundError:        # never built, or retired since
            pass
        nvcc = _nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        src = out.with_suffix(".cu")
        tmp_src, tmp_out = _own(src), _own(out)
        tmp_src.write_text(text)
        os.replace(tmp_src, src)
        t0 = time.perf_counter()
        proc = subprocess.run(
            [nvcc, *CUBIN_FLAGS, "-I", str(CSRC), "-o", str(tmp_out),
             str(src)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        seconds = time.perf_counter() - t0
        if proc.returncode:
            tmp_out.unlink(missing_ok=True)
            raise RuntimeError(f"kernel build failed: {src.name} (nvcc exit "
                               f"{proc.returncode}):\n{proc.stdout}")
        tmp_log = _own(out.with_suffix(".log"))
        tmp_log.write_text(proc.stdout)
        os.replace(tmp_log, out.with_suffix(".log"))
        image = tmp_out.read_bytes()
        os.replace(tmp_out, out)          # atomic: concurrent builds agree
        return out, seconds, image


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
    return log_usage(library_path(name).with_suffix(".log"))


def log_usage(log: Path) -> list[dict]:
    """``resource_usage`` read from the build log ``log``."""
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
