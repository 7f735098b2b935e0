"""The port stands alone: it imports neither jax nor the JAX package."""
import ast
import subprocess
import sys
from pathlib import Path

import incubator_mxnet_tpu_torch

PKG = Path(incubator_mxnet_tpu_torch.__file__).resolve().parent
FORBIDDEN = ("jax", "jaxlib", "incubator_mxnet_tpu")


def _forbidden(name):
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def test_no_forbidden_import_in_source():
    found = []
    for path in sorted(PKG.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            found += [f"{path.name}: {n}" for n in names if _forbidden(n)]
    assert not found, found


def test_runtime_imports_stay_isolated():
    """A fresh interpreter builds and runs a tiny GPT on the CPU without
    loading jax or the reference package."""
    code = (
        "import sys, torch\n"
        "import incubator_mxnet_tpu_torch as mx\n"
        "from incubator_mxnet_tpu_torch.models import gpt_tiny\n"
        "m = gpt_tiny(vocab_size=50, max_length=32, dropout=0.0,"
        " device='cpu', seed=0)\n"
        "out = m.generate(torch.zeros((1, 3), dtype=torch.long), 4)\n"
        "assert out.shape == (1, 7)\n"
        "bad = [n for n in sys.modules if n in ('jax', 'jaxlib',"
        " 'incubator_mxnet_tpu') or n.startswith(('jax.', 'jaxlib.',"
        " 'incubator_mxnet_tpu.'))]\n"
        "print('LOADED', bad)\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=240, cwd=PKG.parent)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "LOADED []" in res.stdout
