"""Build the native kernel library with g++ (plain C ABI, loaded by ctypes).

The library is named by a hash of its source and flags and built into
`_build/` beside this file (listed in `.gitignore`). Each build writes to a
name unique to its process and renames the result into place, so processes
that build at the same moment (test workers) never load a half-written
file.
"""

from __future__ import annotations

import hashlib
import logging
import os
import shutil
import subprocess
from pathlib import Path

log = logging.getLogger(__name__)

SRC_DIR = Path(__file__).parent
BUILD_DIR = SRC_DIR / "_build"
_SOURCE = SRC_DIR / "ggml_kernels.cc"
_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC", "-pthread")


def lib_path() -> Path:
    """Path of the library for the current source and flags."""
    h = hashlib.sha256(_SOURCE.read_bytes())
    h.update(" ".join(_FLAGS).encode())
    return BUILD_DIR / f"libspeaksense_native_{h.hexdigest()[:16]}.so"


def build() -> Path | None:
    """Compile ggml_kernels.cc unless the library for this source exists.
    Returns its path, or None when there is no g++. A failed compile
    raises: the caller does not fall back to numpy behind a broken build."""
    out = lib_path()
    if out.is_file():
        return out
    gxx = shutil.which("g++")
    if gxx is None:
        log.info("g++ not found; native kernels disabled")
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"{out.stem}.{os.getpid()}.tmp.so"
    run = subprocess.run([gxx, *_FLAGS, str(_SOURCE), "-o", str(tmp)],
                         capture_output=True, text=True, timeout=180)
    if run.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"g++ failed on {_SOURCE.name}:\n{run.stderr[-2000:]}")
    os.replace(tmp, out)
    log.info("built native kernels: %s", out)
    return out


def build_sanitizer(kind: str = "address") -> Path | None:
    """Build and run the sanitizer harness (sanitize_test.cc) against the
    kernels. kind: 'address' (ASAN+UBSAN) or 'thread' (TSAN). Returns the
    binary's path after a clean run, raises on sanitizer findings, None
    without g++."""
    gxx = shutil.which("g++")
    if gxx is None:
        log.info("g++ not found; sanitizer run skipped")
        return None
    san = "address,undefined" if kind == "address" else "thread"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"sanitize_{kind}.{os.getpid()}"
    cmd = [gxx, f"-fsanitize={san}", "-g", "-O1", "-std=c++17", "-pthread",
           str(_SOURCE), str(SRC_DIR / "sanitize_test.cc"), "-o", str(out)]
    subprocess.run(cmd, check=True, capture_output=True, timeout=300)
    run = subprocess.run([str(out)], capture_output=True, timeout=300)
    if run.returncode != 0:
        raise RuntimeError(
            f"{kind} sanitizer run failed:\n"
            f"{run.stdout.decode()[-1000:]}\n{run.stderr.decode()[-3000:]}")
    return out
