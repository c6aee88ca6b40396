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


# the gadget and recursion modules of the Keccak-256 and recursion slice,
# the lookup-heavy circuit's builder, and the rest of the circuit library
# (the wrappers, queues, Blake2s, non-native field and curve gadgets, the
# gate-testing harness and the native witness engine's bindings)
SLICE_MODULES = (
    "boojum_tpu_torch.gadgets.lookup_heavy",
    "boojum_tpu_torch.gadgets.keccak256",
    "boojum_tpu_torch.gadgets.num",
    "boojum_tpu_torch.gadgets.poseidon2_circuit",
    "boojum_tpu_torch.gadgets.recursion",
    "boojum_tpu_torch.gadgets.recursion.primitives",
    "boojum_tpu_torch.gadgets.recursion.verifier",
    "boojum_tpu_torch.gadgets.recursion.circuits",
    "boojum_tpu_torch.prover.convenience",
    "boojum_tpu_torch.gadgets.wrappers",
    "boojum_tpu_torch.gadgets.queue",
    "boojum_tpu_torch.gadgets.blake2s",
    "boojum_tpu_torch.gadgets.non_native",
    "boojum_tpu_torch.gadgets.curves",
    "boojum_tpu_torch.cs.gates.testing",
    "boojum_tpu_torch.utils.native",
)


def test_slice_modules_import_without_jax():
    """Importing every module of the slice in a fresh interpreter loads
    neither JAX nor the JAX package."""
    import subprocess
    import sys
    code = ("import sys\n" + "".join("import %s\n" % m for m in SLICE_MODULES)
            + "bad = sorted(m for m in sys.modules if m.split('.')[0] in %r)\n"
            "assert not bad, bad\n" % (FORBIDDEN,))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr


@pytest.mark.parametrize("module", SLICE_MODULES)
def test_slice_modules_name_their_source(module):
    """Each module's first line names the files it was copied or ported
    from, and they are in the repo."""
    path = os.path.join(ROOT, *module.split("."))
    path = path + ".py" if os.path.exists(path + ".py") else \
        os.path.join(path, "__init__.py")
    with open(path) as f:
        first = f.readline()
    assert first.startswith(("# Copied from ", "# Port of ")), first
    sources = [w.rstrip(".,:;") for w in first.split()
               if w.rstrip(".,:;").endswith(".py") or ".py:" in w]
    assert sources, first
    for src in sources:
        assert os.path.exists(os.path.join(ROOT, src.split(":")[0])), src
