"""The port as a package: ``find_packages`` sees it and its subpackages, the
package data lists its CUDA sources, the lazy top-level API resolves
without importing JAX, the build directory follows its environment
variable, and no module of the port (nor ``chip_smoke.py``) imports JAX,
the JAX package, ``regex`` or ``safetensors``, or Pillow at module level
(the GPU machine has none of the first four)."""

import ast
import fnmatch
import os
import subprocess
import sys
import tomllib

import pytest

import image_editing_framework_torch as port
from image_editing_framework_torch.ops import _cuda

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "image_editing_framework_torch")
API = ("SDPipeline", "ddim_invert", "null_text_inversion", "p2p_edit", "masactrl_edit", "pnp_edit", "p2z_edit",
       "random_pipeline", "tiny_pipeline", "load_pipeline", "CLIPTokenizer", "run_sweep")


def _pyproject():
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as f:
        return tomllib.load(f)


def test_find_packages_sees_the_port():
    import setuptools

    include = _pyproject()["tool"]["setuptools"]["packages"]["find"]["include"]
    found = set(setuptools.find_packages(where=ROOT, include=include))
    subpackages = {f"image_editing_framework_torch.{name}" for name in
                   ("core", "data", "eval", "inversion", "methods", "models", "ops", "parallel", "tools", "utils")}
    assert {"image_editing_framework_torch"} | subpackages <= found
    assert "image_editing_framework_tpu" in found  # the JAX package still installs


def test_package_data_lists_the_cuda_sources():
    patterns = _pyproject()["tool"]["setuptools"]["package-data"]["image_editing_framework_torch"]
    sources = [f"csrc/{name}" for name in os.listdir(os.path.join(PKG, "csrc"))]
    assert any(s.endswith(".cu") for s in sources) and any(s.endswith(".cuh") for s in sources)
    for source in sources:
        assert any(fnmatch.fnmatch(source, p) for p in patterns), source


def test_lazy_api_resolves_without_jax():
    """In a fresh interpreter: importing the package and every name of its
    API imports no module of JAX or of the JAX package; a name not ported
    yet raises AttributeError."""
    code = (
        "import sys\n"
        "before = set(sys.modules)\n"
        "import image_editing_framework_torch as port\n"
        f"for name in {API!r}: assert callable(getattr(port, name)), name\n"
        "new = set(sys.modules) - before\n"
        "bad = sorted(m for m in new if m.split('.')[0] in ('jax', 'jaxlib', 'flax', 'image_editing_framework_tpu',"
        " 'regex', 'safetensors', 'PIL'))\n"
        "assert not bad, bad\n"
        "for name in ('CLIPScore', 'serve'):\n"
        "    try:\n"
        "        getattr(port, name)\n"
        "    except AttributeError:\n"
        "        continue\n"
        "    raise AssertionError(name)\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", out.stderr


def test_api_names_are_the_modules_functions():
    from image_editing_framework_torch.eval import sweep
    from image_editing_framework_torch.methods import p2z
    from image_editing_framework_torch.methods.masactrl import masactrl_edit
    from image_editing_framework_torch.methods.pnp import pnp_edit
    from image_editing_framework_torch.models.registry import load_pipeline
    from image_editing_framework_torch.models.tokenizer import CLIPTokenizer

    assert port.masactrl_edit is masactrl_edit and port.pnp_edit is pnp_edit
    assert port.p2z_edit is p2z.p2z_edit
    assert port.load_pipeline is load_pipeline and port.CLIPTokenizer is CLIPTokenizer
    assert port.run_sweep is sweep.run_sweep
    assert set(API) <= set(dir(port))
    for name in ("CLIPScore", "validate_pipeline"):  # not in the JAX package's top-level API either
        with pytest.raises(AttributeError):
            getattr(port, name)


def test_build_dir_follows_its_variable(monkeypatch, tmp_path):
    monkeypatch.delenv(_cuda.BUILD_DIR_ENV, raising=False)
    assert _cuda.build_dir() == os.path.join(PKG, "_build")
    monkeypatch.setenv(_cuda.BUILD_DIR_ENV, str(tmp_path))
    assert _cuda.build_dir() == str(tmp_path)
    src, lib = _cuda._target("flash_fwd")
    assert src == os.path.join(PKG, "csrc", "flash_fwd.cu") and os.path.dirname(lib) == str(tmp_path)
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert "image_editing_framework_torch/_build/" in f.read().split()


def _imported_roots(path):
    """(roots imported anywhere, roots imported at module level) of a file."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)

    def roots(nodes):
        out = set()
        for node in nodes:
            if isinstance(node, ast.Import):
                out |= {alias.name.split(".")[0] for alias in node.names}
            elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
                out.add(node.module.split(".")[0])
        return out

    top = [node for node in tree.body if isinstance(node, (ast.Import, ast.ImportFrom))]
    return roots(ast.walk(tree)), roots(top)


def test_the_port_imports_no_jax():
    """Nowhere: JAX, the JAX package, ``regex``, ``safetensors``; not at
    module level: Pillow (``utils/images.py`` imports it inside the call
    that needs it)."""
    files = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, names in os.walk(PKG):
        files += [os.path.join(dirpath, name) for name in names if name.endswith(".py")]
    assert len(files) > 35
    for path in files:
        anywhere, top = _imported_roots(path)
        bad = anywhere & {"jax", "jaxlib", "flax", "optax", "image_editing_framework_tpu", "regex", "safetensors"}
        assert not bad, (path, bad)
        assert "PIL" not in top, path
    assert "PIL" in _imported_roots(os.path.join(PKG, "utils", "images.py"))[0]


def test_every_module_of_the_jax_package_has_its_port():
    """Each module of the JAX package has a file of the same path in the
    port, but three that need none: ``utils/jax_cache.py`` (JAX's
    compilation cache), ``models/init_utils.py`` (Flax initialisers) and
    ``native/__init__.py`` (its reader is ``models/loader.py``'s)."""
    jax_pkg = os.path.join(ROOT, "image_editing_framework_tpu")
    modules = {os.path.relpath(os.path.join(d, n), jax_pkg) for d, _, names in os.walk(jax_pkg) for n in names
               if n.endswith(".py")}
    missing = sorted(m for m in modules if not os.path.exists(os.path.join(PKG, m)))
    assert missing == ["models/init_utils.py", "native/__init__.py", "utils/jax_cache.py"]
    for name in ("parallel/sharding.py", "utils/profiling.py"):
        assert os.path.exists(os.path.join(PKG, name)), name


def test_every_root_tool_has_its_port():
    """Each repo-root tool (``tools/*.py``, the JAX package's: each imports
    JAX or the JAX package, or launches one that does) has a counterpart
    under the port's ``tools/`` of the same name, but the benchmark tools
    (``bench_serve``, ``bench_sweep``, ``profile_unet``: the port's
    benchmark is work of its own) and the two flash benches, whose twins
    were named for the port's kernels."""
    twins = {"bench_flash_t": "bench_flash_fwd", "bench_flash_bwd_t": "bench_flash_bwd"}
    benchmarks = {"bench_serve", "bench_sweep", "profile_unet"}
    tools = os.path.join(ROOT, "tools")
    names = sorted(name[:-3] for name in os.listdir(tools) if name.endswith(".py"))
    jax_users = [name for name in names if _imported_roots(os.path.join(tools, f"{name}.py"))[0]
                 & {"jax", "image_editing_framework_tpu"}]
    assert len(jax_users) == 10 and "convert_checkpoint" in jax_users
    missing = [name for name in names if name not in benchmarks
               and not os.path.exists(os.path.join(PKG, "tools", f"{twins.get(name, name)}.py"))]
    assert missing == []
    assert benchmarks <= set(jax_users)
