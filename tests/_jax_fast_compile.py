"""The JAX reference's programs compiled with XLA's cheap settings.

The port's parity tests run the JAX package on tiny models only to hold
the port to it. XLA's CPU backend spends most of their seconds
optimizing the compiled programs and generating their fused loops;
compiled without those passes and with its older loop emitters a
program computes the same f32 function (in another summation order at
most) in a fraction of the time. `fast_compile()` gives every program
JAX compiles while it is active these options (a module of tests wraps
itself in it with a module-scoped autouse fixture); the repo's conftest
drops the compiled programs when a module ends, so no other module runs
them.
"""
import contextlib

from jax._src import compiler

OPTIONS = {"xla_backend_optimization_level": 0,
           "xla_llvm_disable_expensive_passes": True,
           "xla_cpu_use_fusion_emitters": False}


@contextlib.contextmanager
def fast_compile():
    orig = compiler.get_compile_options

    def get_compile_options(*args, env_options_overrides=None, **kw):
        return orig(*args, env_options_overrides={
            **OPTIONS, **(env_options_overrides or {})}, **kw)

    compiler.get_compile_options = get_compile_options
    try:
        yield
    finally:
        compiler.get_compile_options = orig

