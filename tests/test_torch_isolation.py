"""The port imports nothing of JAX or of the JAX package.

In a fresh interpreter, importing every module of ``mtad_gat_tpu_torch``
and loading ``chip_smoke.py`` and the root bench scripts of the port
(``BENCH_SCRIPTS``, without running their ``main``) leaves ``jax``,
``flax``, ``msgpack`` (the port reads flax's checkpoints with its own
decoder: the card's machine has no ``msgpack``) and every ``mtad_gat_tpu.``
module out of ``sys.modules``; and an AST scan of the package, of
``chip_smoke.py`` and of those scripts finds no such import.
"""

import ast
import os
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parent.parent
PORT = REPO / "mtad_gat_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "mtad_gat_tpu", "msgpack")
BENCH_SCRIPTS = ("bench_edges_torch.py", "bench_long_torch.py", "bench_entities_torch.py",
                 "bench_attrib_torch.py")
SCRIPTS = ("chip_smoke.py",) + BENCH_SCRIPTS


def _port_files():
    return sorted(PORT.rglob("*.py")) + [REPO / name for name in SCRIPTS]


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in FORBIDDEN


def test_no_forbidden_import_in_the_source():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(REPO)}:{node.lineno} {n}" for n in names if _forbidden(n)]
    assert not bad, bad


def test_importing_the_port_loads_no_jax():
    modules = sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )
    code = (
        "import importlib, importlib.util, sys\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m)\n"
        f"for name in {SCRIPTS!r}:\n"
        f"    path = {str(REPO)!r} + '/' + name\n"
        "    spec = importlib.util.spec_from_file_location(name[:-3], path)\n"
        "    spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert not bad, bad\n"
        "print(len(sys.modules))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert len(modules) > 20
