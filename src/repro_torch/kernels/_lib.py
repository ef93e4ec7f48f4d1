"""Builds the port's CUDA kernels and loads them with ctypes.

Every ``csrc/*.cu`` is compiled for Hopper (``sm_90a``) by ``nvcc`` into one
shared library with a plain C interface: no PyTorch header is included, so a
build takes seconds.  Each source compiles in its own ``nvcc`` process, all
started together, and one more ``nvcc`` links the objects.  The library lands
in ``build/kernels/`` at the repository root under a name that carries a hash
of the sources, so an edited source is rebuilt at its first use.

Each exported function takes device pointers, ints (flash_attn also a float
scale) and the current CUDA stream, allocates nothing and returns
``cudaGetLastError()``; ``check`` raises on anything but 0.  Nothing here runs at import: the library is built
and loaded by the first wrapper that launches a kernel.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence

import torch

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
SOURCES = ("beam_step.cu", "commit_merge.cu", "flash_attn.cu", "gather_score.cu",
           "mips_topk.cu", "quant_score.cu", "topk_merge.cu")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas=-v")

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# name -> argtypes (the stream is the last pointer of each)
SIGNATURES = {
    "beam_step_f32": [_P] * 8 + [_I] * 5 + [_P] * 8 + [_P],
    "beam_step_i8": [_P] * 9 + [_I] * 5 + [_P] * 8 + [_P],
    "beam_walk_f32": [_P] * 10 + [_I] * 8 + [_P] * 7 + [_P],
    "beam_walk_i8": [_P] * 11 + [_I] * 8 + [_P] * 7 + [_P],
    "commit_merge_f32": [_P] * 6 + [_I] * 4 + [_P],
    "flash_attn_f32": [_P] * 3 + [_I] * 6 + [_F] + [_I] * 2 + [_P] + [_P],
    "flash_attn_bf16": [_P] * 3 + [_I] * 6 + [_F] + [_I] * 2 + [_P] + [_P],
    "gather_score_f32": [_P] * 3 + [_I] * 3 + [_P] + [_P],
    "mips_topk_f32": [_P] * 2 + [_I] * 6 + [_P] * 4 + [_P],
    "mips_topk_i8": [_P] * 3 + [_I] * 6 + [_P] * 4 + [_P],
    "mips_topk_select_f32": [_P] * 2 + [_I] * 7 + [_P] * 3 + [_P],
    "mips_topk_select_i8": [_P] * 3 + [_I] * 7 + [_P] * 3 + [_P],
    "quant_score_i8": [_P] * 4 + [_I] * 3 + [_P] + [_P],
    "topk_merge_f32": [_P] * 6 + [_I] * 3 + [_P] * 3 + [_P],
}


def source_hash() -> str:
    h = hashlib.sha256()
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    return str(Path(home) / "bin" / "nvcc")


def compile_commands(out_dir: Path) -> List[List[str]]:
    """One ``nvcc -c`` per source, each writing ``<source>.o`` in ``out_dir``."""
    return [
        [nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-c", str(CSRC / src),
         "-o", str(out_dir / f"{src}.o")]
        for src in SOURCES
    ]


def link_command(objects: Sequence[Path], out: Path) -> List[str]:
    return [nvcc(), *ARCH, "-shared", "-o", str(out), *map(str, objects)]


def library_path() -> Path:
    return BUILD_DIR / f"librepro_torch_{source_hash()}.so"


def build() -> Path:
    """Compile and link the library unless this source hash is built already.
    Returns its path; raises with the compiler's output if a step fails."""
    out = library_path()
    if out.exists():
        return out
    work = BUILD_DIR / out.stem
    work.mkdir(parents=True, exist_ok=True)
    cmds = compile_commands(work)
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    logs = [p.communicate()[0] for p in procs]
    (work / "build.log").write_text("\n".join(logs))
    for cmd, proc, log in zip(cmds, procs, logs):
        if proc.returncode:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{log}")
    tmp = work / out.name
    link = subprocess.run(
        link_command([work / f"{s}.o" for s in SOURCES], tmp),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{link.stdout}")
    os.replace(tmp, out)
    return out


def build_log() -> str:
    """The compilers' output of the current build (registers, spills)."""
    return (BUILD_DIR / library_path().stem / "build.log").read_text()


@functools.cache
def lib() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    handle = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(handle, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return handle


def stream(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError {rc}")


def expect(t: torch.Tensor, name: str, dtype: torch.dtype, shape: Sequence[int],
           device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` -- what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def on_cuda(t: torch.Tensor) -> bool:
    """True for a CUDA tensor (launch the kernel), False for a CPU one (run
    the plain version); any other device raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")
