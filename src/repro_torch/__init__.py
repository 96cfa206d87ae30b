"""PyTorch/CUDA port of the AFD serving system.

The package mirrors ``repro``'s module names (``models``, ``kernels``,
``parallel``, ``serving``, ``fleet``, ``core``, ``api``, ``provision``,
``configs``, ``launch``, ``training``) so each module's JAX counterpart is
easy to find. It imports ``torch`` and numpy only: nothing of ``jax`` and
nothing of ``repro``. ``core``, ``api`` and ``provision`` (but
``provision.calibrate``'s run) are numpy only and import no torch.

Entry points run on the CUDA device unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version. ``python -m repro_torch plan | sweep | bench | provision | list``
is the analysis front door (``provision --calibrate`` runs the serving
engine on the card), ``serve-traffic`` drives the two-role serving
engine, ``serve-fleet`` a fleet of them, ``serve`` the single-program
model behind the continuous-batching ``DecodeEngine``, ``train`` the
training driver.
"""
