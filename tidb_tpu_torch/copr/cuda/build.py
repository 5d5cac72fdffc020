"""Build the hand-written CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/*.cu`` file is compiled on its own into a shared library with
a plain C interface (no PyTorch headers, so a build takes seconds):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -Xptxas=-v \\
         -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The output lives under ``build/kernels/`` at the repository root and is
named by a hash of the source and the flags, so an edited source
rebuilds and an unchanged one loads what is there.  ``build_all``
starts one nvcc per source, all at once, and waits for every one; a
kernel's first use builds its own source alone.  A
failed build raises with nvcc's output; a build's registers and spills
per kernel (ptxas's report) are kept for ``ptxas_report``.  Nothing is
built at import.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List, Tuple

from ...util_concurrency import make_lock

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

#: one build at a time: held across the nvcc processes and the rename of
#: their outputs, so two threads never compile the same source
_mu = make_lock("copr.cuda.build:_mu")
_LIBS: Dict[str, ctypes.CDLL] = {}
_LOGS: Dict[str, str] = {}  # name -> nvcc's output of a build in this process
_RUNS = [0]  # nvcc processes started in this process


def nvcc_runs() -> int:
    """How many nvcc processes this process has started (the lint's
    recompile guard: a second run of its corpus must start none)."""
    with _mu:
        return _RUNS[0]


def sources() -> Dict[str, Path]:
    """Kernel name -> its .cu source, for every source in csrc/."""
    return {p.stem: p for p in sorted(CSRC.glob("*.cu"))}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def _target(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all(names=None) -> Dict[str, float]:
    """Compile every kernel source (or those of `names`) not yet built,
    one nvcc each, run concurrently; returns name -> seconds spent
    building it (0.0 when its library was already there)."""
    with _mu:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        todo, secs = {}, {}
        for name, src in sources().items():
            if names is not None and name not in names:
                continue
            out = _target(src)
            if out.exists():
                secs[name] = 0.0
                continue
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
            _RUNS[0] += 1
            todo[name] = (proc, tmp, out, time.perf_counter())
        failed = []
        for name, (proc, tmp, out, t0) in todo.items():
            log, _ = proc.communicate()
            secs[name] = time.perf_counter() - t0
            _LOGS[name] = log
            if proc.returncode != 0:
                failed.append(f"{name}: nvcc exit {proc.returncode}\n{log}")
                tmp.unlink(missing_ok=True)
                continue
            os.replace(tmp, out)  # atomic: readers never see a partial .so
        if failed:
            raise RuntimeError("CUDA kernel build failed:\n"
                               + "\n".join(failed))
        return secs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of one kernel source, building it first when
    needed."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    src = sources()[name]
    if not _target(src).exists():
        build_all([name])
    with _mu:
        lib = _LIBS.get(name)
        if lib is None:
            lib = _LIBS[name] = ctypes.CDLL(str(_target(src)))
        return lib


def ptxas_report(name: str) -> List[Tuple[str, int, int, int]]:
    """(kernel, registers, spill store bytes, spill load bytes) for each
    entry function of `name`, from ptxas's report of a build made in this
    process (empty when the library was already built).  Kernel names
    are demangled with cu++filt where the toolkit has it."""
    fns, cur = {}, None
    for line in _LOGS.get(name, "").splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = m.group(1)
            fns[cur] = [0, 0, 0]
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m and cur in fns:
            fns[cur][1:] = [int(m.group(1)), int(m.group(2))]
        m = re.search(r"Used (\d+) registers", line)
        if m and cur in fns:
            fns[cur][0] = int(m.group(1))
    names = list(fns)
    filt = os.path.join(os.path.dirname(_nvcc()), "cu++filt") if fns else ""
    if fns and os.path.exists(filt):
        out = subprocess.run([filt, *fns], capture_output=True, text=True)
        if out.returncode == 0 and len(out.stdout.splitlines()) == len(fns):
            names = out.stdout.splitlines()
    return [(nm, *fns[k]) for nm, k in zip(names, fns)]
