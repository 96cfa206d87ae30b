"""PyTorch/CUDA port of the AFD serving system.

The package mirrors ``repro``'s module names (``models``, ``kernels``,
``parallel``, ``serving``, ``fleet``, ``core``, ``configs``, ``launch``)
so each module's JAX counterpart is easy to find. It imports ``torch``
and numpy only: nothing of ``jax`` and nothing of ``repro``.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version. ``python -m repro_torch serve-traffic`` drives the two-role
serving engine, ``serve-fleet`` a fleet of them, ``serve`` the
single-program model behind the continuous-batching ``DecodeEngine``.
"""
