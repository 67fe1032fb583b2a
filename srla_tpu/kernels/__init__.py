"""JAX and Pallas device paths.

Importing this package (which every device code path does before tracing
its first program) configures the persistent XLA compilation cache.  The
setup lives HERE rather than in the top-level ``srla_tpu/__init__`` so that
pure-host usage (backend="exact"/"native") never imports jax at all: a codec
user who never touches the device path does not pay for the jax runtime.
"""

import os as _os
import sys as _sys

# Fixed in-checkout cache directory (listed in .gitignore). A fixed path
# keeps the cache's keys stable from one process to the next.
CACHE_DIR = _os.path.join(
    _os.path.dirname(_os.path.dirname(_os.path.dirname(
        _os.path.abspath(__file__)))), ".xla_cache")


def cache_dir_for(backend: str) -> str | None:
    """Where the persistent compilation cache lives for `backend`: None when
    JAX_COMPILATION_CACHE_DIR is set (jax reads it itself and nothing else
    is set here), else CACHE_DIR, with XLA:CPU entries in a per-host
    subdirectory (see _host_fingerprint)."""
    if _os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    if backend == "cpu":
        return _os.path.join(CACHE_DIR, "cpu-" + _host_fingerprint())
    return CACHE_DIR


def enable_xla_cache() -> None:
    """Persistent XLA compilation cache. Idempotent. A directory that cannot
    be created turns the cache off, and says so on stderr."""
    import jax
    path = cache_dir_for(jax.default_backend())
    if path is None or jax.config.jax_compilation_cache_dir:
        return  # configured through the environment (or already by us)
    try:
        _os.makedirs(path, exist_ok=True)
    except OSError as e:
        print(f"srla_tpu: compilation cache off ({path}: {e})",
              file=_sys.stderr)
        return
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def _host_fingerprint() -> str:
    """Cache-dir suffix tying XLA:CPU AOT entries to this host's ISA.

    The cache key does NOT cover the compile host's CPU features, and
    XLA:CPU AOT executables compiled on a machine with a different feature
    set SIGSEGV/SIGILL when deserialized (observed: a cache entry written
    on an avx512-era host segfaulted jax's get_executable_and_time on a
    later machine — the cpu_aot_loader feature-mismatch warning escalated
    from 'harmless fallback' to a crash). Device entries are
    host-independent and stay in the shared directory."""
    try:
        import hashlib
        import platform
        flags = model = ""
        try:
            with open("/proc/cpuinfo") as f:
                for line in f:  # first CPU stanza only
                    if not line.strip():
                        break
                    key = line.split(":", 1)[0].strip()
                    if key == "flags" and not flags:
                        flags = " ".join(sorted(line.split(":", 1)[1].split()))
                    elif key in ("model name", "model", "cpu family",
                                 "stepping"):
                        model += line.strip() + ";"
        except OSError:
            pass
        # Include the CPU model/family/stepping and the jaxlib version, not
        # just the feature flags: LLVM AOT tunes to the specific core (and a
        # flag-identical host segfaulted on a foreign entry anyway), and a
        # jaxlib bump changes the executable format.
        try:
            import jaxlib
            ver = getattr(jaxlib, "__version__", "")
        except Exception:
            ver = ""
        h = hashlib.sha256(
            (platform.machine() + "|" + model + "|" + flags + "|" + ver)
            .encode()).hexdigest()[:12]
        return h
    except Exception:
        return "generic"


enable_xla_cache()


import contextlib as _contextlib


@_contextlib.contextmanager
def sharded_cpu_cache_bypass(mesh):
    """Skip the persistent cache while compiling MESH-SHARDED programs on
    the XLA:CPU backend.

    jaxlib's CPU executable deserialization for multi-device (sharded)
    programs aborts/segfaults when the entry is re-read inside a process
    that has already loaded many other executables (observed repeatedly in
    the full suite at tests/test_parallel.py::test_fused_dispatch_actually_
    sharded, on entries freshly written by the same jaxlib on the same
    host; a standalone write-then-reread of the identical program passes).
    Single-device CPU entries and ALL device entries are unaffected
    and stay cached. Cost: virtual-mesh tests and the multichip dryrun
    recompile their sharded programs per process.

    Nulling jax_compilation_cache_dir (the round-4 version of this bypass)
    does NOT work: jax memoizes cache use at first compile
    (compilation_cache.is_cache_used's _cache_checked / _get_cache's
    one-shot _initialize_cache), so once any program has compiled with the
    cache on, later reads ignore the dir config entirely — the r5 full
    suite still segfaulted inside get_executable_and_time with the dir
    nulled. The working lever is jax_enable_compilation_cache +
    reset_cache(), which clears the memoization on BOTH edges (entry: so
    the disable is seen; exit: so later single-device compiles re-enable
    the on-disk cache).
    """
    if mesh is None:
        yield
        return
    try:
        import jax
        if jax.default_backend() != "cpu":
            yield
            return
        from jax._src import compilation_cache as _cc
        old = jax.config.jax_enable_compilation_cache
        jax.config.update("jax_enable_compilation_cache", False)
        _cc.reset_cache()
    except Exception:
        yield
        return
    try:
        yield
    finally:
        try:
            jax.config.update("jax_enable_compilation_cache", old)
            _cc.reset_cache()
        except Exception:
            pass
