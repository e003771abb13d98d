"""The PyTorch port imports nothing of JAX, flax or ``raft_stereo_tpu``,
no port module imports PIL or cv2 at module level, and the training path's
modules import neither anywhere (the card's machine has neither).

Checked twice: a fresh interpreter imports every module of the port and
inspects ``sys.modules`` (a subprocess, because this pytest process has
already imported jax), and an AST scan of every port source backs it up.
A third check reads a KITTI tree through the eval modules, and a fourth
loads an augmented SceneFlow batch, in a fresh interpreter where
importing PIL or cv2 fails. A fifth runs ``--help`` of every command of
``python -m raft_stereo_tpu_torch.cli`` where importing jax, flax or the
JAX package fails.
"""

import ast
import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = "raft_stereo_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "raft_stereo_tpu")
NOT_ON_CARD = ("PIL", "cv2")  # lazily imported by the demo only


def _forbidden(name: str, forbidden=FORBIDDEN) -> bool:
    return any(name == f or name.startswith(f + ".") for f in forbidden)


def _imported_names(node):
    if isinstance(node, ast.Import):
        return [a.name for a in node.names]
    if isinstance(node, ast.ImportFrom) and node.level == 0:
        return [node.module or ""]
    return []


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
    # the policy lint is the port's own copy, not the JAX package's
    assert f"{PKG}.obs.validate" in mods
    # and so are the report tools
    for m in ("obs.summarize", "obs.compare", "obs.timeline", "obs.doctor",
              "obs.fleet", "obs.numerics", "utils.profiling", "cli"):
        assert f"{PKG}.{m}" in mods, m
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
    bad = [m for m in loaded if _forbidden(m, FORBIDDEN + NOT_ON_CARD)]
    assert not bad, f"port import pulled in {bad[:10]}"


def test_cli_commands_run_without_jax():
    """``python -m raft_stereo_tpu_torch.cli <command> --help`` for every
    command of the root command line, in one interpreter where importing
    jax, flax or the JAX package raises: each exits 0, and none of them is
    loaded after."""
    from raft_stereo_tpu_torch.cli import COMMANDS
    code = f"""
import contextlib, importlib.abc, io, json, runpy, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {FORBIDDEN!r}:
            raise ImportError("refused: " + name)
sys.meta_path.insert(0, Refuse())
codes = {{}}
for cmd in {COMMANDS!r}:
    sys.argv = ["raft_stereo_tpu_torch.cli", cmd, "--help"]
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        try:
            runpy.run_module("raft_stereo_tpu_torch.cli", run_name="__main__",
                             alter_sys=True)
            codes[cmd] = None
        except SystemExit as e:
            codes[cmd] = e.code
    codes[cmd] = [codes[cmd] or 0, len(out.getvalue())]
print(json.dumps([codes, sorted(m for m in sys.modules
                                if m.split(".")[0] in {FORBIDDEN!r})]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    codes, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert sorted(codes) == sorted(COMMANDS)
    assert all(rc == 0 and n > 0 for rc, n in codes.values()), codes
    assert loaded == []


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
                offenders += [f"{path}: {n}" for n in _imported_names(node)
                              if _forbidden(n)]
            # module level: the body outside functions (and classes' bodies)
            stack = list(tree.body)
            while stack:
                node = stack.pop()
                if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    continue
                offenders += [f"{path}: {n} at module level"
                              for n in _imported_names(node)
                              if _forbidden(n, NOT_ON_CARD)]
                stack.extend(ast.iter_child_nodes(node))
    assert not offenders, offenders


def test_eval_reads_kitti_tree_without_pil_or_cv2(tmp_path):
    """Write a KITTI tree with the port's own writers and read every frame
    (images, 16-bit disparity, a flow PNG) through the eval modules, in an
    interpreter where importing PIL or cv2 raises."""
    code = f"""
import importlib.abc, json, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {NOT_ON_CARD!r}:
            raise ImportError("no " + name + " on the card")
sys.meta_path.insert(0, Refuse())
import numpy as np
from raft_stereo_tpu_torch.data import datasets, frame_utils, png
from raft_stereo_tpu_torch.eval import validate
from raft_stereo_tpu_torch import evaluate
root = {str(tmp_path)!r} + "/KITTI/training"
import os
rng = np.random.default_rng(0)
for d in ("image_2", "image_3", "disp_occ_0"):
    os.makedirs(f"{{root}}/{{d}}")
for i in range(2):
    for d in ("image_2", "image_3"):
        png.write_png(f"{{root}}/{{d}}/00000{{i}}_10.png",
                      rng.integers(0, 255, (20, 30, 3), dtype=np.uint8))
    png.write_png(f"{{root}}/disp_occ_0/00000{{i}}_10.png",
                  rng.integers(0, 9000, (20, 30), dtype=np.uint16))
ds = datasets.KITTI(root={str(tmp_path)!r} + "/KITTI")
shapes = [ds.sample(i)["image1"].shape for i in range(len(ds))]
frame_utils.write_flow_kitti(root + "/flow.png", rng.normal(size=(4, 5, 2)))
frame_utils.read_flow_kitti(root + "/flow.png")
print(json.dumps([shapes, sorted(m for m in sys.modules
                                 if m.split(".")[0] in {NOT_ON_CARD!r})]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    shapes, loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert shapes == [[20, 30, 3], [20, 30, 3]]
    assert loaded == []


TRAINING_PATH = ("data/augment.py", "data/loader.py", "data/datasets.py",
                 "training/resilience.py", "training/checkpoint.py",
                 "training/logger.py", "training/trainer.py",
                 "obs/numerics.py", "train.py", "cli.py",
                 "parallel/mesh.py", "parallel/distributed.py",
                 "parallel/data_parallel.py")


def test_training_path_imports_no_opencv_or_pil():
    """The training path's modules import neither cv2 nor PIL anywhere,
    not even inside a function (the augmentor computes OpenCV's resize and
    colour conversions itself)."""
    offenders = []
    for rel in TRAINING_PATH:
        path = os.path.join(REPO, PKG, rel)
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            offenders += [f"{rel}: {n}" for n in _imported_names(node)
                          if _forbidden(n, FORBIDDEN + NOT_ON_CARD)]
    assert not offenders, offenders


def test_loader_augments_without_opencv_or_pil(tmp_path):
    """A SceneFlow tree written by the port's own writers, loaded and
    augmented at the recipe's settings in an interpreter where importing
    PIL, cv2 or jax raises: one sample made in that interpreter, and the
    loader's first batch (its worker processes make the same sample)."""
    code = f"""
import importlib.abc, json, sys
class Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path, target=None):
        if name.split(".")[0] in {NOT_ON_CARD + ("jax",)!r}:
            raise ImportError("no " + name + " on the card")
sys.meta_path.insert(0, Refuse())
import numpy as np
from chip_smoke import write_sceneflow_tree
from raft_stereo_tpu_torch.config import sceneflow_config
from raft_stereo_tpu_torch.data import datasets
from raft_stereo_tpu_torch.data.loader import Loader, sample_rng
write_sceneflow_tree({str(tmp_path)!r}, 2, 48, 96, 0, max_disp=8)
cfg = sceneflow_config()[1]
aug = dict(datasets.train_aug_params(cfg), crop_size=(32, 48))
ds = datasets.build_train_dataset(("sceneflow",), aug, {str(tmp_path)!r})
loader = Loader(ds, batch_size=2, seed=0, num_workers=1, shuffle=False)
batch = next(iter(loader))
loader.close()
here = ds.sample(0, sample_rng(0, 0, 0))
print(json.dumps([list(batch["image1"].shape), str(batch["image1"].dtype),
                  bool(np.array_equal(here["image1"], batch["image1"][0])),
                  sorted(m for m in sys.modules
                         if m.split(".")[0] in {NOT_ON_CARD!r})]))
"""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    shape, dtype, same, loaded = json.loads(
        out.stdout.strip().splitlines()[-1])
    assert shape == [2, 32, 48, 3] and dtype == "float32" and same
    assert loaded == []
