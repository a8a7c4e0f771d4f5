"""Persistent compilation cache location.

When JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself and this
module sets no other directory.  Otherwise the cache lives at a fixed
`.jax_cache` under the checkout (found from this package's own path),
in a subdirectory keyed by a host fingerprint: XLA:CPU caches AOT
executables specialized to the compiling machine's feature set, and
loading them on a different CPU fails with machine-feature-mismatch
errors, so each machine gets its own subtree.
"""

from __future__ import annotations

import hashlib
import os
import platform

CHECKOUT_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def host_fingerprint() -> str:
    """Stable-per-machine, distinct-across-machines cache key: CPU
    feature flags + architecture (the exact inputs XLA:CPU specializes
    AOT results against)."""
    feats = ""
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("flags", "Features")):
                    feats = " ".join(sorted(line.split(":", 1)[1].split()))
                    break
    except OSError:
        pass
    raw = f"{platform.machine()}|{feats}"
    return hashlib.sha256(raw.encode()).hexdigest()[:12]


def compilation_cache_dir() -> str:
    """The directory the persistent compilation cache uses."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    return os.path.join(CHECKOUT_CACHE, host_fingerprint())


def setup_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at compilation_cache_dir()
    (leaving an environment-given directory to JAX).  Returns the
    directory."""
    import jax

    path = compilation_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
