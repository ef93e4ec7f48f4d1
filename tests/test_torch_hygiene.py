"""The port's boundaries: it imports neither JAX nor the JAX package, its
kernels build for Hopper, and its entry points never fall back to the CPU
quietly."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.kernels import _lib

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path):
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


@pytest.mark.parametrize("path", PORT_FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_port_imports_neither_jax_nor_the_jax_package(path):
    bad = [m for m in _imported_modules(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_importing_the_port_leaves_jax_unloaded():
    code = ("import sys, repro_torch.launch.serve, repro_torch.convert, repro_torch.testing, "
            "repro_torch.core.mutation, repro_torch.launch.serve_loop, "
            "repro_torch.kernels.topk_merge, repro_torch.kernels.flash_attn; "
            "print(sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro')))")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env=env, timeout=120, check=True).stdout
    assert out.strip() == "[]"


def test_nvcc_commands_target_sm90a(tmp_path):
    cmds = _lib.compile_commands(tmp_path)
    assert [Path(c[c.index("-c") + 1]).name for c in cmds] == list(_lib.SOURCES)
    link = _lib.link_command([tmp_path / "a.o"], tmp_path / "lib.so")
    for cmd in cmds + [link]:
        assert "arch=compute_90a,code=sm_90a" in cmd
    assert "-shared" in link
    assert all({"-O3", "-std=c++17", "-fPIC"} <= set(c) for c in cmds)
    assert _lib.library_path().name.endswith(f"{_lib.source_hash()}.so")
    assert all((_lib.CSRC / s).exists() for s in (*_lib.SOURCES, "select.cuh"))


def test_wrappers_check_the_device():
    with pytest.raises(ValueError):
        _lib.on_cuda(torch.zeros(1, device="meta"))
    assert _lib.on_cuda(torch.zeros(1)) is False


@pytest.mark.parametrize("entry", ["ipnsw", "ipnsw_plus", "serve", "mutable", "serve_loop"])
def test_default_device_raises_without_cuda(entry):
    if torch.cuda.is_available():
        pytest.skip("checks a host without CUDA")
    from repro_torch.core.ipnsw import IpNSW
    from repro_torch.core.ipnsw_plus import IpNSWPlus
    from repro_torch.core.mutation import MutableIndex
    from repro_torch.launch import serve

    items = np.random.default_rng(0).normal(size=(64, 8)).astype(np.float32)
    with pytest.raises((RuntimeError, AssertionError)):
        if entry == "serve":
            serve.main(["--n-items", "64", "--dim", "8", "--batch", "4"])
        elif entry == "serve_loop":
            serve.main(["--loop", "--n-items", "64", "--dim", "8", "--batch", "4",
                        "--requests", "4"])
        elif entry == "mutable":
            MutableIndex(IpNSW().build(items), capacity=80).upsert(items[:4])
        else:
            (IpNSW if entry == "ipnsw" else IpNSWPlus)().build(items)


def test_serve_one_shot_on_cpu(capsys):
    from repro_torch.launch import serve

    res = serve.main(["--index", "ipnsw", "--n-items", "600", "--dim", "16", "--batch", "16",
                      "--device", "cpu"])
    assert "[serve] index=ipnsw" in capsys.readouterr().out
    assert res["recall"] > 0.8
    res = serve.main(["--index", "bruteforce", "--n-items", "300", "--dim", "16",
                      "--batch", "8", "--device", "cpu"])
    assert res["recall"] == 1.0
