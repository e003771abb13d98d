"""The PyTorch port imports nothing of JAX, flax or ``raft_stereo_tpu``.

Checked twice: a fresh interpreter imports every module of the port and
inspects ``sys.modules`` (a subprocess, because this pytest process has
already imported jax), and an AST scan of every port source backs it up.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "raft_stereo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_stereo_tpu")


def _forbidden(name: str) -> bool:
    return any(name == f or name.startswith(f + ".") for f in FORBIDDEN)


def _port_modules():
    """Every module of the port, by walking its source tree."""
    mods = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        rel = os.path.relpath(root, REPO).replace(os.sep, ".")
        for fn in sorted(files):
            if fn == "__init__.py":
                mods.append(rel)
            elif fn.endswith(".py"):
                mods.append(f"{rel}.{fn[:-3]}")
    return sorted(mods)


def test_port_modules_load_no_jax():
    mods = _port_modules()
    assert f"{PKG}.ops.kernels.windowed_sample" in mods
    code = ("import importlib, json, sys\n"
            f"for m in {mods!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(sys.modules)))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert set(mods) <= set(loaded)
    bad = [m for m in loaded if _forbidden(m)]
    assert not bad, f"port import pulled in {bad[:10]}"


def test_port_sources_import_no_jax():
    offenders = []
    for root, _, files in os.walk(os.path.join(REPO, PKG)):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(root, fn)
            with open(path) as f:
                tree = ast.parse(f.read(), path)
            for node in ast.walk(tree):
                names = []
                if isinstance(node, ast.Import):
                    names = [a.name for a in node.names]
                elif isinstance(node, ast.ImportFrom) and node.level == 0:
                    names = [node.module or ""]
                offenders += [f"{path}: {n}" for n in names if _forbidden(n)]
    assert not offenders, offenders
