"""The PyTorch port imports and runs without JAX, and none of its sources
(nor chip_smoke.py) imports JAX or the JAX package."""
import ast
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "gpr_calculator_tpu_torch"


def test_port_imports_with_jax_blocked():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "import importlib, pkgutil\n"
        "import gpr_calculator_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "for m in ('neb', 'mep', 'optimize', 'io.ase_db', 'io.ulm',\n"
        "          'io.trajectory', 'io.vasp', 'calculators.lj', 'parallel',\n"
        "          'parallel.mesh', 'parallel.sharded_kernels',\n"
        "          'parallel.cholesky', 'parallel.dryrun', 'md', 'analysis',\n"
        "          'utils', 'utils_profiling', 'ops.linalg',\n"
        "          'examples.md_onthefly', 'examples.emt_serial',\n"
        "          'examples.emt_batched'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n"
        "from gpr_calculator_tpu_torch.parallel import make_mesh\n"
        "assert make_mesh(4, ['cpu'] * 4).size == 4\n"
        "assert callable(p.neb_calc) and callable(p.get_images)\n"
        "assert callable(p.GP.set_GPR) and callable(p.GP.load)\n"
        "assert callable(p.GP.predict_structures)\n"
        "assert callable(p.GP.sparsify) and callable(p.models.CUR)\n"
        "assert p.SO3(stress=True).stress\n"
        "assert callable(p.neb.OnTheFlyBatchedNEB) and callable(p.io.read)\n"
        "assert not any(k == 'gpr_calculator_tpu'\n"
        "               or k.startswith('gpr_calculator_tpu.')\n"
        "               for k in sys.modules)\n"
        "print('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def _imported_modules(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_no_port_source_names_jax_in_an_import():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "gpr_calculator_tpu"), (
                f"{path.relative_to(ROOT)} imports {mod}")


def test_packaging_finds_the_parallel_package():
    """pyproject.toml finds packages by the pattern gpr_calculator_tpu*:
    the port's sub-packages, parallel among them, are inside it."""
    import tomllib
    from setuptools import find_packages
    cfg = tomllib.loads((ROOT / "pyproject.toml").read_text())
    include = cfg["tool"]["setuptools"]["packages"]["find"]["include"]
    found = find_packages(str(ROOT), include=include)
    for pkg in ("parallel", "ops", "models", "examples"):
        assert f"gpr_calculator_tpu_torch.{pkg}" in found
