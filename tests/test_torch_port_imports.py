"""The port stands alone: ``v1t_tpu_torch`` and ``chip_smoke.py`` import no
JAX and nothing of the JAX package (checked on the source, by an AST scan),
the serving modules import without PyYAML, and ``chip_smoke.py`` fails
without a CUDA device or without the port beside it."""

import ast
import os
import pathlib
import shutil
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "optax", "v1t_tpu"}


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


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_import(path):
    assert not _imported_roots(path) & FORBIDDEN


def test_scan_sees_a_forbidden_import(tmp_path):
    bad = tmp_path / "bad.py"
    bad.write_text("import os\nfrom v1t_tpu.ops import common\nimport jax.numpy as jnp\n")
    assert _imported_roots(bad) & FORBIDDEN == {"v1t_tpu", "jax"}


def _run(args, cwd, env_extra=None):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env, capture_output=True,
                          text=True, timeout=300)


def test_port_imports_without_jax_or_yaml():
    # a meta-path hook refuses jax, flax, yaml and the JAX package
    code = (
        "import sys\n"
        "class Refuse:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name.split('.')[0] in {'jax', 'jaxlib', 'flax', 'yaml', 'v1t_tpu'}:\n"
        "            raise ImportError('refused ' + name)\n"
        "sys.meta_path.insert(0, Refuse())\n"
        "import v1t_tpu_torch.models, v1t_tpu_torch.training, v1t_tpu_torch.utils.torch_export\n"
        "import v1t_tpu_torch.configs, v1t_tpu_torch._build, chip_smoke\n"
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
