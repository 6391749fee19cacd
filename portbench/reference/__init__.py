"""The benchmark's plain reference: the simulator's semantics, as the
JAX package (``src/repro/netsim``, ``src/repro/core`` and the vector
programs of ``src/repro/kernels``) states them, translated to NumPy.

The modules here are that package's, with their imports made relative,
``jax.numpy`` and ``jax.lax`` replaced by ``np32`` (NumPy with 32-bit
types, JAX's promotion and functional updates), the kernels' backends cut
to the vector program and the trace counters left out.  Nothing here
imports JAX, the JAX package or the program (``repro_torch``), and
nothing here derives from the program's code: the CPU tests hold this
reference to the JAX package and the program to this reference."""
