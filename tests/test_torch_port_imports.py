"""The port stands alone: ``v1t_tpu_torch`` and ``chip_smoke.py`` import no
JAX, nothing of the JAX package and no ml_dtypes (checked on the source of
every module, by an AST scan); PyYAML, matplotlib, TensorBoard, scipy and
PIL are imported only inside the functions that need them, so every module
imports without them; and ``chip_smoke.py`` fails without a CUDA device or
without the port beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "v1t_tpu", "ml_dtypes"}
# imported only inside the functions that need them
LAZY = {"yaml", "matplotlib", "torch.utils.tensorboard", "scipy", "PIL"}


def _sources():
    files = sorted((ROOT / "v1t_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    return files


def _imported_roots(path):
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), filename=str(path))):
        if isinstance(node, ast.Import):
            roots.update(alias.name.split(".")[0] for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            roots.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                roots.add(str(node.args[0].value).split(".")[0])
    return roots


def _module_level_imports(path):
    """Modules imported when ``path`` is imported: every import outside a
    function body, by full dotted name."""
    names = set()

    def visit(node):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            return
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            names.add(node.module)
            names.update(f"{node.module}.{alias.name}" for alias in node.names)
        for child in ast.iter_child_nodes(node):
            visit(child)

    visit(ast.parse(path.read_text(), filename=str(path)))
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & FORBIDDEN
    lazy = {n for n in _module_level_imports(path)
            if any(n == m or n.startswith(m + ".") for m in LAZY)}
    assert not lazy, lazy


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom v1t_tpu.ops import common\nimport jax.numpy as jnp\n"
                   "try:\n    from torch.utils.tensorboard import SummaryWriter\n"
                   "except ImportError:\n    pass\n"
                   "def f():\n    import yaml\n")
    assert _imported_roots(bad) & FORBIDDEN == {"v1t_tpu", "jax"}
    level = _module_level_imports(bad)
    assert "torch.utils.tensorboard" in level and "yaml" not in level


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_without_jax_or_yaml():
    # a meta-path hook refuses jax, flax, optax, ml_dtypes, yaml, matplotlib,
    # tensorboard, scipy, PIL and the JAX package; every module of the port imports
    modules = sorted(
        ".".join(p.relative_to(ROOT).with_suffix("").parts).removesuffix(".__init__")
        for p in (ROOT / "v1t_tpu_torch").rglob("*.py")
        if "tools" not in p.parts and p.name != "gen_wgmma.py")
    assert {"v1t_tpu_torch.train", "v1t_tpu_torch.data.loaders", "v1t_tpu_torch.metrics",
            "v1t_tpu_torch.utils.scheduler", "v1t_tpu_torch.utils.plots",
            "v1t_tpu_torch.submission", "v1t_tpu_torch.ensemble", "v1t_tpu_torch.demo",
            "v1t_tpu_torch.import_checkpoint", "v1t_tpu_torch.export_checkpoint",
            "v1t_tpu_torch.models.ensemble", "v1t_tpu_torch.analysis.attention_rollout",
            "v1t_tpu_torch.pretrain.__main__", "v1t_tpu_torch.pretrain.data",
            "v1t_tpu_torch.pretrain.ssim", "v1t_tpu_torch.pretrain.tasks",
            "v1t_tpu_torch.pretrained", "v1t_tpu_torch.sweep", "v1t_tpu_torch.utils.profiler",
            "v1t_tpu_torch.misc.estimate_aRFs", "v1t_tpu_torch.misc.core_pca",
            "v1t_tpu_torch.misc.prediction_v_dilation",
            "v1t_tpu_torch.misc.behaviorMLP_visualization",
            "v1t_tpu_torch.misc.figures", "v1t_tpu_torch.misc.extract_attention_maps"
            } <= set(modules)
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'jax', 'jaxlib', 'flax', 'optax', 'yaml', 'v1t_tpu',\n"
        "                                  'ml_dtypes', 'matplotlib', 'tensorboard', 'scipy',\n"
        "                                  'PIL'}\\\n"
        "                or name.startswith('torch.utils.tensorboard'):\n"
        "            raise ImportError('refused ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import importlib\n"
        f"for name in {modules!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "print('ok')\n"
    )
    proc = _run(["-c", code], cwd=ROOT)
    assert proc.returncode == 0 and proc.stdout.strip() == "ok", proc.stderr


def test_chip_smoke_fails_without_cuda():
    proc = _run([str(ROOT / "chip_smoke.py")], cwd=ROOT, env_extra={"CUDA_VISIBLE_DEVICES": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(ROOT / "chip_smoke.py", tmp_path / "chip_smoke.py")
    proc = _run(["chip_smoke.py"], cwd=tmp_path)
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
