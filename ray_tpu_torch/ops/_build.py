"""Build and load the port's CUDA kernels (``ops/csrc/*.cu``).

Each ``.cu`` file is compiled by its own ``nvcc`` process, all started
together, for ``sm_90a`` into an object file; the objects are linked into one
shared library with a plain ``extern "C"`` interface, loaded with ``ctypes``.
The library is named by a hash of the sources and flags and lives in
``ray_tpu_torch/_build/`` (listed in ``.gitignore``), so a stale build is
never reused. The build runs at first use, never at import.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
#: C signatures of the library's entry points (all return a cudaError_t).
SIGNATURES = {
    "rtt_flash_fwd": [_P] * 5 + [_I] * 6 + [_F, _I, _I, _P],
    "rtt_flash_bwd_dq": [_P] * 7 + [_I] * 6 + [_F, _I, _I, _P],
    "rtt_flash_bwd_dkv": [_P] * 8 + [_I] * 6 + [_F, _I, _I, _P],
    # dynamic shared memory of one block at a head_dim (-1: not built for it)
    "rtt_flash_fwd_smem_bytes": [_I],
    "rtt_flash_fwd_tc_smem_bytes": [_I],
    "rtt_flash_bwd_dq_smem_bytes": [_I],
    "rtt_flash_bwd_dq_tc_smem_bytes": [_I],
    "rtt_flash_bwd_dkv_smem_bytes": [_I],
    "rtt_flash_bwd_dkv_tc_smem_bytes": [_I],
}


def nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(cuda_home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin, /usr/local/cuda/bin, PATH)")
    return found


def _digest(csrc: Path = CSRC) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def build(csrc: Optional[Path] = None, build_dir: Optional[Path] = None) -> tuple:
    """Compile the kernels in ``csrc`` (default: the package's ``csrc/``)
    into ``build_dir`` (default ``BUILD_DIR``) if this source hash has no
    library there yet.

    Returns ``(library_path, report)``: ``report`` holds the build seconds
    (0.0 when the library was already built) and the compiler's
    ``-Xptxas -v`` output (registers, shared memory, spills per kernel)."""
    csrc = CSRC if csrc is None else Path(csrc)
    build_dir = BUILD_DIR if build_dir is None else Path(build_dir)
    sources = sorted(csrc.glob("*.cu"))
    digest = _digest(csrc)
    lib = build_dir / f"libray_tpu_torch_kernels_{digest}.so"
    log = lib.with_suffix(".log")
    if lib.exists():
        ptxas = log.read_text() if log.exists() else ""
        return lib, {"seconds": 0.0, "cached": True, "ptxas": ptxas}
    build_dir.mkdir(parents=True, exist_ok=True)
    exe = nvcc()
    tag = f"{digest}.{os.getpid()}"
    t0 = time.perf_counter()
    objs = [build_dir / f"{src.stem}.{tag}.o" for src in sources]
    tmp = build_dir / f"lib.{tag}.so"
    try:
        procs = [subprocess.Popen([exe, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
                                  stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        outputs = [p.communicate()[0] for p in procs]
        failed = [(s.name, out) for s, p, out in zip(sources, procs, outputs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(f"--- {n}\n{o}" for n, o in failed))
        link = subprocess.run([exe, "-shared", *ARCH, "-o", str(tmp), *map(str, objs)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    report = "\n".join(f"--- {s.name}\n{o}" for s, o in zip(sources, outputs))
    log.write_text(report)
    os.replace(tmp, lib)
    return lib, {"seconds": time.perf_counter() - t0, "cached": False, "ptxas": report}


def load(path: Path) -> ctypes.CDLL:
    """Load a built kernel library and declare its entry points' types."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    return load(build()[0])


def ptxas_summary(report: str) -> list:
    """Registers and spill bytes per kernel instantiation from -Xptxas -v.
    The tensor-core kernels (``*_tc_kernel``) are bf16, the others f32."""
    rows, name = [], None
    for line in report.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            sym = m.group(1)
            kind = re.search(r"(flash_\w+?_kernel)", sym)
            dim = re.search(r"Li(\d+)E", sym)
            tc = "bfloat16" in sym or bool(kind and kind.group(1).endswith("_tc_kernel"))
            name = (kind.group(1) if kind else sym, "bf16" if tc else "f32",
                    int(dim.group(1)) if dim else None)
            spill = None
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append({"kernel": name[0], "dtype": name[1], "d": name[2],
                         "registers": int(m.group(1)), "spill_bytes": spill})
            name = None
    return rows
