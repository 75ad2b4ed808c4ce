"""Tracing / profiling / debugging helpers (SURVEY.md §5 tracing).

The reference instruments with wall-clock prints (Vent_Analysis.py:318,333;
CI.py:122-143).  Here:
- `trace(profile_dir)` wraps a block in jax.profiler (TensorBoard/Perfetto
  traces) when a directory is given;
- `stage(name)` adds jax.named_scope annotations so pipeline stages are
  visible in traces;
- `timed(name)` measures wall time around a block (the caller ends the
  block with jax.block_until_ready);
- `enable_debug_checks()` turns on NaN/Inf interception for tests
  (the sanitizer analog, SURVEY.md §5 race detection).
"""
from __future__ import annotations

import contextlib
import time
from typing import Iterator, Optional

import jax


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[None]:
    if not profile_dir:
        yield
        return
    jax.profiler.start_trace(profile_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def stage(name: str):
    """jax.named_scope alias for pipeline stage annotation."""
    return jax.named_scope(name)


@contextlib.contextmanager
def timed(name: str, sink=print) -> Iterator[None]:
    t0 = time.perf_counter()
    yield
    sink(f"[ventjax] {name}: {time.perf_counter() - t0:.3f}s")


def enable_debug_checks(nans: bool = True, infs: bool = True) -> None:
    jax.config.update("jax_debug_nans", nans)
    jax.config.update("jax_debug_infs", infs)


# XLA's GPU determinism option: deterministic reductions and scatters, and
# no autotuning.  chip_smoke.py checks the name against the card's XLA.
GPU_DETERMINISM_FLAG = "xla_gpu_deterministic_ops"


def enable_deterministic() -> None:
    """Bitwise-deterministic XLA programs (the CLI's --deterministic).

    Appends the GPU's determinism flag (deterministic reductions and
    scatters, at some cost in speed) and turns off CPU fast math.  XLA
    reads XLA_FLAGS when its backend starts, so call this before the first
    computation; flags already present are left as the user set them.
    """
    import os

    flags = os.environ.get("XLA_FLAGS", "").split()
    for flag in (f"--{GPU_DETERMINISM_FLAG}=true",
                 "--xla_cpu_enable_fast_math=false"):
        if not any(f.split("=")[0] == flag.split("=")[0] for f in flags):
            flags.append(flag)
    os.environ["XLA_FLAGS"] = " ".join(flags)


def default_compile_cache_dir() -> str:
    """The compile cache's fixed place when JAX_COMPILATION_CACHE_DIR is not
    set: ``.jax_cache`` at the root of the checkout that holds this package.

    A fixed path, independent of the working directory, the process and the
    time: JAX keys cached programs by their content, so one directory
    serves every run of this checkout.
    """
    import os

    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    return os.path.join(os.path.dirname(pkg), ".jax_cache")


def compile_cache_dir() -> Optional[str]:
    """The persistent compile cache directory in use for this process, or
    None when VENTJAX_NO_CACHE disables it."""
    import os

    if os.environ.get("VENTJAX_NO_CACHE"):
        return None
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or default_compile_cache_dir())


def enable_compile_cache() -> Optional[str]:
    """Persistent XLA compilation cache.

    Every CLI invocation is a fresh process, and the fused pipeline's
    compile takes seconds to tens of seconds; the cache pays it once per
    program.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
    and this sets no other directory; otherwise the cache lives at
    default_compile_cache_dir().  VENTJAX_NO_CACHE=1 (or the CLI's
    --no-compile-cache, which skips this call) disables it.  Returns the
    directory in use, or None when disabled.
    """
    import os

    cache_dir = compile_cache_dir()
    if cache_dir is None:
        return None
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        os.makedirs(cache_dir, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", cache_dir)
        # the cache backend initializes once; if this process already
        # compiled something, re-point it at the directory
        from jax.experimental.compilation_cache import compilation_cache

        compilation_cache.reset_cache()
    # cache every program: the pipeline is a few large jits, and even the
    # small helper programs are worth keeping across processes
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return cache_dir
