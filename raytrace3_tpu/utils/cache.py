"""Persistent JAX compilation cache shared by the entry points."""

from __future__ import annotations

import os

import jax

#: The repository checkout's own cache directory (listed in .gitignore).
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache; returns its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set JAX already uses it and nothing
    is set here; otherwise the cache lives at the fixed ``REPO_CACHE_DIR``
    (a fixed path, so later processes hit the same entries).
    """
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
