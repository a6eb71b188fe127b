"""JAX's persistent compilation cache, set up in one place.

Pipeline-scale jits (``slam_step`` and friends) take tens of seconds to
compile; every entry point (runner, bench, tools, tests, ``chip_smoke.py``)
calls ``enable()`` so later processes reuse what an earlier one compiled.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
directory is set here. Otherwise the cache lives at a fixed path inside the
checkout (``<repo>/.jax_cache``, git-ignored): the path is part of the
cache's identity, so it must not move between runs.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def cache_dir() -> str:
    """The directory the cache uses: the environment's, else the repo's."""
    return os.environ.get(ENV_VAR) or REPO_CACHE_DIR


def enable() -> str:
    """Turn the persistent cache on; returns the directory in use."""
    import jax

    if not os.environ.get(ENV_VAR):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    # cache only what took long to compile (pipeline-scale jits)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return cache_dir()
