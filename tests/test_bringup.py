"""The GPU entry scripts refuse the CPU, the compile-cache location, and the
flax-free pytree dataclass."""

import dataclasses
import json
import os
import runpy
import subprocess
import sys
from pathlib import Path
from typing import Optional

import jax
import jax.numpy as jnp
import pytest

from lqp_py_tpu.utils import compile_cache, pytree

REPO = Path(__file__).resolve().parent.parent


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    return env


def test_chip_smoke_refuses_cpu(capsys):
    """No GPU: chip_smoke exits non-zero and prints no result line."""
    sys.path.insert(0, str(REPO))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(REPO))
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main([])
    assert exc.value.code not in (0, None)
    assert '"ok"' not in capsys.readouterr().out


def test_bench_refuses_cpu(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["bench.py", "--sizes", "8"])
    with pytest.raises(SystemExit) as exc:
        runpy.run_path(str(REPO / "bench.py"), run_name="__main__")
    assert exc.value.code not in (0, None)
    assert "metric" not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Copied alone into an empty directory, the script fails without a
    result line (it needs the package beside it)."""
    (tmp_path / "chip_smoke.py").write_text(
        (REPO / "chip_smoke.py").read_text())
    out = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path,
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode != 0
    assert '"ok"' not in out.stdout


@pytest.mark.parametrize("env,expected", [
    ("/some/where/cache", "/some/where/cache"),
    (None, str(REPO / ".jax_cache")),
    ("", str(REPO / ".jax_cache")),
])
def test_compile_cache_dir(monkeypatch, env, expected):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    assert compile_cache.cache_dir() == expected


def test_enable_compile_cache_sets_jax_config(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    old = jax.config.jax_compilation_cache_dir
    try:
        assert compile_cache.enable_compile_cache() == str(tmp_path)
        assert jax.config.jax_compilation_cache_dir == str(tmp_path)
    finally:
        jax.config.update("jax_compilation_cache_dir", old)


def test_repo_cache_is_gitignored():
    assert ".jax_cache/" in (REPO / ".gitignore").read_text().split()


@pytree.dataclass
class _State:
    a: jax.Array
    b: Optional[jax.Array] = None
    tag: str = pytree.static_field(default="x")


def test_pytree_dataclass_replace_and_frozen():
    s = _State(a=jnp.ones(3))
    t = s.replace(b=jnp.zeros(2), tag="y")
    assert s.b is None and s.tag == "x"
    assert t.tag == "y" and t.b.shape == (2,)
    with pytest.raises(dataclasses.FrozenInstanceError):
        s.a = jnp.zeros(3)


def test_pytree_dataclass_flatten_under_jit():
    s = _State(a=jnp.arange(3.0), b=jnp.ones(2), tag="k")
    leaves, treedef = jax.tree_util.tree_flatten(s)
    assert len(leaves) == 2                      # tag is treedef metadata
    assert jax.tree_util.tree_unflatten(treedef, leaves).tag == "k"

    @jax.jit
    def f(st):
        return st.replace(a=st.a * 2)

    out = f(s)
    assert isinstance(out, _State) and out.tag == "k"
    assert jnp.array_equal(out.a, jnp.arange(3.0) * 2)
    # A different static value is a different treedef (a retrace), not a
    # traced value.
    assert (jax.tree_util.tree_structure(s)
            != jax.tree_util.tree_structure(s.replace(tag="other")))


def test_package_imports_without_flax_or_orbax():
    code = (
        "import sys\n"
        "class Block:\n"
        "    def find_spec(self, name, path, target=None):\n"
        "        if name.split('.')[0] in ('flax', 'orbax'):\n"
        "            raise ImportError(name)\n"
        "sys.meta_path.insert(0, Block())\n"
        "import lqp_py_tpu, json\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        "                        if m.split('.')[0] in ('flax', 'orbax'))))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env=_env())
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
