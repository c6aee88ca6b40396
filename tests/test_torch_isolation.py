"""The port stands alone: no file of `boojum_tpu_torch/`, and not
`chip_smoke.py`, imports JAX or the JAX package; and the entry points run on
the GPU by default, raising where there is none instead of running on the
CPU."""

import ast
import os

import pytest
import torch

from boojum_tpu_torch.prover import DeviceProver, create_device_setup

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "boojum_tpu")


def _port_files():
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(ROOT, "boojum_tpu_torch")):
        files.extend(os.path.join(dirpath, n) for n in names if n.endswith(".py"))
    return files


def _imported_modules(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") \
                == "__import__" and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield node.args[0].value


def test_port_imports_neither_jax_nor_reference():
    files = _port_files()
    assert len(files) > 30
    bad = [(os.path.relpath(p, ROOT), m) for p in files
           for m in _imported_modules(p)
           if m.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_entry_points_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("this box has a GPU; the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        DeviceProver(None, None, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        create_device_setup(None, None, None)
