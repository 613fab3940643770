"""No module of the benchmark imports JAX or the JAX package: top-level
module names are compared whole (the port's name begins with the JAX
package's)."""
import ast
from pathlib import Path

FORBIDDEN = {"jax", "jaxlib", "flax", "lumenrenderer_tpu"}
BENCH = Path(__file__).resolve().parents[1]


def _top_level_imports(path: Path):
    tree = ast.parse(path.read_text(), str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "")
              == "import_module" and node.args
              and isinstance(node.args[0], ast.Constant)):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    files = sorted(BENCH.rglob("*.py"))
    assert len(files) > 10
    found = {(str(p.relative_to(BENCH)), name) for p in files
             for name in _top_level_imports(p) if name in FORBIDDEN}
    assert not found


def test_the_port_is_not_mistaken_for_the_jax_package():
    names = set(_top_level_imports(BENCH / "port.py"))
    assert "lumenrenderer_tpu_torch" in names
    assert not names & FORBIDDEN


def test_run_finds_loaded_jax_modules(run_mod):
    assert "lumenrenderer_tpu_torch" not in run_mod.FORBIDDEN
    assert run_mod.forbidden_modules(
        ["lumenrenderer_tpu_torch.ops", "torch", "numpy"]) == []
    assert run_mod.forbidden_modules(
        ["jax.numpy", "lumenrenderer_tpu.render", "flaxen"]) == [
            "jax", "lumenrenderer_tpu"]
