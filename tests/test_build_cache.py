"""Build keys of the native libraries, and the compile cache's location."""
import os

import pytest

from tpubwa.native import build


def _src(tmp_path, body: str) -> str:
    path = tmp_path / "lib.cpp"
    path.write_text('extern "C" int answer() { return ' + body + '; }\n')
    return str(path)


def test_stale_or_foreign_library_is_rebuilt(tmp_path):
    """A library keyed to other sources or flags is never reused: an edit
    of the source, or other flags, builds a new one beside it."""
    import ctypes

    out = str(tmp_path / "out")
    src = _src(tmp_path, "41")
    flags = ("-O1", "-shared", "-fPIC")
    first = build.keyed_build("g++", flags, [src], [], out, "libx")
    assert build.keyed_build("g++", flags, [src], [], out, "libx") == first
    src = _src(tmp_path, "42")   # same path, new contents
    second = build.keyed_build("g++", flags, [src], [], out, "libx")
    assert second != first and ctypes.CDLL(second).answer() == 42
    third = build.keyed_build("g++", ("-O2", "-shared", "-fPIC"), [src],
                              [], out, "libx")
    assert third not in (first, second)


def test_failed_build_raises_with_compiler_message(tmp_path):
    src = _src(tmp_path, "not_declared")
    with pytest.raises(RuntimeError, match="not_declared"):
        build.keyed_build("g++", ("-shared", "-fPIC"), [src], [],
                          str(tmp_path / "out"), "libbad")


def test_native_library_is_keyed_and_portable():
    """The main path loads a keyed library from native/build, built for
    the portable target, never the unkeyed file of older checkouts."""
    lib = build.load_native()
    path = build.library_path()
    assert os.path.dirname(path).endswith(os.path.join("native", "build"))
    assert os.path.basename(path).startswith("libtpubwa-")
    assert not any("march" in f for f in build.FLAGS)
    assert lib is build.load_native()


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    import jax

    from tpubwa.utils.cache import enable_compile_cache

    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert enable_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_default_is_checkout(monkeypatch):
    import jax

    from tpubwa.utils.cache import CHECKOUT, enable_compile_cache

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = enable_compile_cache()
        assert path == os.path.join(root, ".jax_cache") and CHECKOUT == root
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
