"""The compile-cache helper and chip_smoke.py's refusal to run without a GPU."""

import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    import jax

    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_env_set(monkeypatch, tmp_path, restore_cache_dir):
    import jax

    from localhgt_tpu.utils import compile_cache

    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert compile_cache.configure() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # not overridden


def test_compile_cache_env_unset(monkeypatch, restore_cache_dir):
    import jax

    from localhgt_tpu.utils import compile_cache

    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    want = os.path.join(ROOT, ".jax_cache")
    assert compile_cache.configure() == want
    assert compile_cache.configure() == want  # the same on every run
    assert jax.config.jax_compilation_cache_dir == want


@pytest.mark.parametrize("argv", [[], ["--four"]])
def test_chip_smoke_refuses_cpu(argv, capsys):
    sys.path.insert(0, ROOT)
    try:
        import chip_smoke
    finally:
        sys.path.remove(ROOT)
    with pytest.raises(SystemExit) as exc:
        chip_smoke.main(argv)
    assert exc.value.code not in (0, None)
    assert '"ok": true' not in capsys.readouterr().out


def test_chip_smoke_alone_fails(tmp_path):
    """Outside the checkout (the script and nothing else) it fails and
    prints no result."""
    script = tmp_path / "chip_smoke.py"
    script.write_bytes(open(os.path.join(ROOT, "chip_smoke.py"), "rb").read())
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["JAX_PLATFORMS"] = "cpu"
    p = subprocess.run([sys.executable, str(script)], cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
